"""The yardstick's counts against hand counts at the cells' shapes."""

import json

from benchmark import flops
from conftest import REPO

GPT2 = json.loads((REPO / "benchmark/configs/gpt2_medium_c2i.json").read_text())


def test_gpt2_medium_forward_per_token_by_hand():
    d, layers, vocab, t = 1024, 24, 17384, 257
    projections = 2 * (d * 3 * d + d * d + d * 4 * d + 4 * d * d)  # c_attn, c_proj, mlp_fc, mlp_proj
    attention = 2 * t * d + 2 * t * d  # q·k over t columns, probabilities · v
    head = 2 * d * vocab
    assert flops.gpt2_forward_per_token(d, layers, vocab, t) == layers * (projections + attention) + head
    assert flops.gpt2_forward_per_token(d, layers, vocab, t) == 664_846_336


def test_counted_ar_step_is_three_forwards_plus_the_encoder():
    b, s = 2, 256
    total, nbytes = flops.ar_step(GPT2, b, s)
    encoder, _ = flops.encode(GPT2["ir"], b, s)
    gpt2 = total - encoder
    by_hand = 3 * flops.gpt2_forward_per_token(1024, 24, 17384, 257) * b * 257
    # autograd takes no gradient of the token ids: the first layer's input gradient is still
    # counted (the embeddings are trained), so the step is three forwards to within the head's
    # softmax-free bookkeeping
    assert abs(gpt2 - by_hand) / by_hand < 1e-3
    assert nbytes == 28 * GPT2["parameters"] + b * s * s * 3


def test_k1_operations_and_bytes_at_the_export_shape():
    n, k, d = 2560, 16384, 8
    ops, nbytes = flops.k1(n, k, d)
    assert ops == 2 * 2560 * 16384 * 8 == 671_088_640
    assert nbytes == 4 * 2560 * 8 + 4 * 16384 * 8 + 4 * 2560 == 616_448
    assert abs(flops.least_s(ops, nbytes) - ops / 989e12) < 1e-15  # bound by its operations


def test_encode_counts_the_lookup():
    ir = GPT2["ir"]
    f1, _ = flops.encode(ir, 1, 256)
    f10, _ = flops.encode(ir, 10, 256)
    assert f10 == 10 * f1  # linear in the crops: the lookup's 2·N·K·D grows with N too
    assert flops.k1(256, 16384, 8)[0] < f1


def test_least_time_takes_the_larger_bound():
    assert flops.least_s(989e12, 0) == 1.0
    assert flops.least_s(0, 3.35e12) == 1.0
    assert flops.least_s(989e9, 3.35e12) == 1.0
