"""The work counts against hand counts at tiny shapes."""
import pytest

from portbench.counts import work
from portbench.lib import bench

# llama: hidden 8, ff 16, 2 layers, 2 heads of 4, 1 kv head, vocab 10
D = bench.family("llama").Dims(family="llama", hidden=8, ff=16, layers=2, heads=2, kv_heads=1,
                               head_dim=4, vocab=10, max_pos=64, eps=1e-6, tie=False,
                               qk_norm=True, rope_theta=1e4)


def test_layer_macs():
    # q 8x8, k 4x8, v 4x8, o 8x8, gate 16x8, up 16x8, down 8x16
    macs = 64 + 32 + 32 + 64 + 128 + 128 + 128
    assert work.plan(D, 0).token_macs == macs
    assert work.model_macs(D) == 2 * macs and work.attention_layers(D) == 2


def test_causal_attention_flops_and_bytes():
    # QK^T and PV over the 3 * 4 / 2 = 6 causal pairs of 3 tokens, 2 heads of 4
    assert work.causal_attention_flops(D, 3) == 2 * 2 * 6 * 4 * 2
    # q and o (2 heads), k and v (1 head): 3 tokens x 4 x (2 + 2 + 1 + 1) x 2 bytes
    assert work.causal_attention_bytes(D, 3) == 3 * 4 * 6 * 2


def test_gptq_flops_by_hand():
    # m 2, n 3, rank 2: column 0 updates 2 later columns, column 1 one: 3 x 2 rows x 2
    assert work.gptq_flops(2, 3, 2) == 12
    assert work.gptq_flops(2, 3, 3) == 12     # the last column has nothing after it
    assert work.gptq_flops(2, 3, 1) == 8


def test_k2_launch_least_time_is_the_larger_of_ops_and_bytes():
    m, b, g = 4096, 256, 128
    nbytes = 4 * m * b * 2 + 4 * b * b + 0.5 * m * b + 8 * m * b / g
    ops = m * b * b
    # at b = 256 the f32 operations bound it (4.0 us against 2.8 us of bytes)
    assert work.k2_launch_least_s(m, b, g) == pytest.approx(ops / 67e12)
    assert ops / 67e12 > nbytes / 3.35e12
    # a narrow block is bound by its bytes
    assert work.k2_launch_least_s(m, 16, g) == pytest.approx(
        (4 * m * 16 * 2 + 4 * 16 * 16 + 0.5 * m * 16 + 8 * m * 16 / g) / 3.35e12)


def test_quantize_layer_least_time_by_hand():
    tokens, seq = 6, 3
    fwd = 2 * 576 * 6 + work.causal_attention_flops(D, 3) * 2
    gram = (8 * 8 * 3 + 16 * 16) * 6
    ranks = [8, 8, 8, 16]
    f32 = 3 * 8 ** 3 / 3 + 16 ** 3 / 3
    f32 += sum(work.gptq_flops(m, 8, 8) for m in (8, 4, 4)) + work.gptq_flops(8, 8, 8)
    f32 += sum(work.gptq_flops(m, 8, 8) for m in (16, 16)) + work.gptq_flops(8, 16, 16)
    want = (fwd + gram) / 989e12 + f32 / 67e12
    assert work.quantize_layer_least_s(D, 0, tokens, seq, ranks) == pytest.approx(want)
    # the same with every group's rows given: all the tokens
    assert work.quantize_layer_least_s(D, 1, tokens, seq, ranks, [6] * 4) == pytest.approx(want)


def test_window_flops_by_hand():
    per_tok = 2 * 576 * 2 + 2 * 10 * 8         # linears of 2 layers, the head
    attn = 4 * 4 * 2 * 2                       # a context position, 2 layers
    # a prompt of 3 whose first token came in the window, then outputs 1 and 2
    want = work.prompt_flops(D, 3) + 2 * per_tok + attn * ((3 + 1) + (3 + 2))
    assert work.window_flops(D, [(3, 0, 3, True)]) == pytest.approx(want)
    # a request already running: only its decode steps in the window
    assert work.window_flops(D, [(3, 1, 2, False)]) == pytest.approx(per_tok + attn * 4)


def test_prompt_flops_by_hand():
    assert work.prompt_flops(D, 3) == 2 * 576 * 2 * 3 + work.causal_attention_flops(D, 3) * 2 \
        + 2 * 10 * 8
