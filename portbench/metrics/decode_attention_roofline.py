"""The least time of the ``decode_attention`` calls the traced rounds
made (one a layer a decode step, over each row's valid cache rows,
``counts``), over the device time of that kernel's launches (split and
combine) in the trace."""


def read(ctx):
    t = ctx.tracer
    if t is None:
        return None
    dev, n = t.kernel_seconds("decode_split_kernel", "decode_tc_kernel",
                              "decode_combine_kernel")
    if n == 0 or dev <= 0:
        return None
    da = ctx.counts("decode_attention")
    c = ctx.cfg
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    D, L = c["hidden_size"] // H, c["num_hidden_layers"]
    S = ctx.traffic["max_len"]
    bound = 0.0
    for log in ctx.traced_rounds:
        for (ids, t0, t1, _), cur in zip(log.batches,
                                         ctx.driver.cur_lens(log)):
            if t.t0 <= t0 and t1 <= t.t1:
                bound += L * da.bound_s(cur, S, H, KV, D)
    return 100.0 * bound / dev
