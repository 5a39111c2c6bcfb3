"""The U-Net's products and convolutions for the image-steps executed
in the window (rows that padding adds not counted), over the window's
seconds at the card's float32-accurate 3xTF32 rate (495 / 3 TFLOP/s)."""


def read(ctx):
    flops = ctx.counts("unet_flops").forward_flops(ctx.cfg)
    peaks = ctx.counts("peaks")
    steps = sum(len(b[0]) for log in ctx.rounds for b in log.batches)
    return 100.0 * steps * flops / (ctx.window_s
                                    * peaks.F32_3XTF32_OPS_PER_S)
