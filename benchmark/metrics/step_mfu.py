"""Model FLOPs of the window over what the card's bf16 dense peak could do in
it: the encoder's matrix products for the real tokens it encoded, plus
``2 Q N D`` for each call's top-k, over the calls completed inside the
window, divided by (window seconds x 989 TFLOP/s), in %."""

from benchmark.lib import roofline


def read(run):
    if not run.completed:
        return None
    arch = run.config
    flops = 0
    for c in run.completed:
        flops += roofline.topk_ops(c.questions, run.layout.rows, run.layout.dim)
        for texts in c.stats.encoded:
            flops += roofline.encoder_flops(
                [run.tokens(t) for t in texts], arch["num_hidden_layers"],
                arch["hidden_size"], arch["intermediate_size"])
    return 100.0 * flops / (run.seconds * roofline.BF16_DENSE_PEAK)
