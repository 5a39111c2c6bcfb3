"""Frozen count of one U-Net forward's products and convolutions, per
image: 2 multiply-adds a product term, as the profilers' flop counters
count them (norms, activations and the DDIM update left out)."""

from __future__ import annotations


def conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * cin * cout * k * k


def forward_flops(cfg: dict) -> int:
    ch, res = cfg["base_channels"], cfg["image_size"]
    mults, nrb = cfg["channel_mults"], cfg["num_res_blocks"]
    attn_res, cin_img = cfg["attn_resolutions"], cfg["in_channels"]
    temb = 4 * ch
    f = 2 * (ch * temb + temb * temb)               # time embedding

    def res_block(r, cin, cout):
        n = conv(r, r, cin, cout, 3) + conv(r, r, cout, cout, 3)
        n += 2 * temb * cout
        if cin != cout:
            n += conv(r, r, cin, cout, 1)
        return n

    def attn(r, c):
        hw = r * r
        return 4 * 2 * hw * c * c + 2 * 2 * hw * hw * c

    f += conv(res, res, cin_img, ch, 3)
    cin, chans = ch, [(ch, res)]
    for li, m in enumerate(mults):
        cout = ch * m
        for _ in range(nrb):
            f += res_block(res, cin, cout)
            if res in attn_res:
                f += attn(res, cout)
            cin = cout
            chans.append((cin, res))
        if li != len(mults) - 1:
            f += conv(res // 2, res // 2, cin, cin, 3)
            res //= 2
            chans.append((cin, res))
    f += 2 * res_block(res, cin, cin) + attn(res, cin)
    for li, m in reversed(list(enumerate(mults))):
        cout = ch * m
        for _ in range(nrb + 1):
            skip_c, skip_res = chans.pop()
            f += res_block(res, cin + skip_c, cout)
            if skip_res in attn_res:
                f += attn(res, cout)
            cin = cout
        if li != 0:
            res *= 2
            f += conv(res, res, cin, cin, 3)
    f += conv(res, res, cin, cin_img, 3)
    return f
