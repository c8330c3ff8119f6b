"""The per-layer plans, the generalised quantize check and the work
counts on a test-only family of two layer kinds with routed groups
(``family_tiny_moe.py``: layer 0 dense, layers 1 and 2 a top-1-of-2
router over the normed hidden, one group for each expert's up and one for
each expert's down; layer 2's expert bias leaves expert 1 with no row).

The reference's own sweep (``control_captures``, in f32; no TF32 on the
CPU) stands in the program's place.  It hands each layer's output on in
bf16, as the program does, and the check recomputes in f32 without that
rounding, so a token whose two router scores tie to within bf16's
rounding would be routed apart on the two sides.  The calibration is a
bank of two four-token phrases: with no attention a token's hidden state
is a function of its id, so the router sees at most eight different
rows, none of them near a tie here (a split route would read in
``gram_rel`` far above its floor)."""
import pytest
import torch

from portbench.counts import work
from portbench.lib import bench, traffic
from portbench.lib.plan import Group
from portbench.lib.verdict import judge
from portbench.reference import check_quantize as cq
from portbench.reference.truncgptq import rtn
from portbench.tests import tiny

CONF = {"family": "tiny_moe", "hidden_size": 32, "intermediate_size": 64,
        "moe_intermediate_size": 32, "num_experts": 2, "layer_types": ["dense", "moe", "moe"],
        "expert_bias": {"2": [0.0, -1000.0]}, "vocab_size": 64, "norm_eps": 1e-5,
        "num_hidden_layers": 3}
S = {"bits": 4, "group": 32, "eps": 1e-6, "pivot_rtol": 1e-5, "block": 32, "batch": 4}
SEEDS = (2**31 + 11, 2**31 + 12)
SAMPLE = 1
LIMITS = {k: tiny.LIMITS[k] for k in cq.NUMBERS}


@pytest.fixture
def moe(monkeypatch):
    mod = bench.load_module(bench.PKG / "tests" / "family_tiny_moe.py")
    real = bench.family
    monkeypatch.setattr(bench, "family", lambda name: mod if name == CONF["family"] else real(name))
    return mod


def _sweep(mod, seed):
    """(dims, the control's captures, the check of a list of captures)."""
    d = mod.dims(CONF)
    ids = traffic.synthetic_calibration(d.vocab, 8, 64, seed, 2, 4)

    def make_layer(li):
        return mod.make_layer(d, seed, li, torch.bfloat16, "cpu")

    outer = mod.make_outer(d, seed, torch.bfloat16, "cpu")
    caps = cq.control_captures(d, make_layer, outer, ids, S, d.layers, SAMPLE, "cpu")

    def check(c):
        return cq.check_sweep(d, make_layer, outer, ids, S, c, set(range(d.layers)), SAMPLE, "cpu")
    return d, caps, check


@pytest.mark.parametrize("seed", SEEDS)
def test_routed_sweep_reads_its_sound_floor(moe, seed):
    d, caps, check = _sweep(moe, seed)
    ok, table = judge(check(caps), LIMITS)
    assert ok, table
    nums = {k: v["value"] for k, v in table.items()}
    assert nums["rank_gap"] == nums["pivot_regret"] == nums["grid_miss"] == 0, nums
    assert nums["gram_rel"] < 5e-3 and nums["factor_rel"] < 1e-5, nums
    # layer 1 routes rows to both experts; layer 2 leaves expert 1 none
    assert all(g.rank > 0 for g in caps[1].groups)
    assert [g.rank for g in caps[2].groups] == [caps[2].groups[0].rank, 0,
                                              caps[2].groups[2].rank, 0]
    # a group fed by no row keeps no pivot: its modules round to nearest
    w = moe.make_layer(d, seed, 2, torch.bfloat16, "cpu")["experts"]["1"]["down_proj"]["w"]
    assert torch.equal(caps[2].modules["experts.1.down_proj"].codes,
                       rtn(w.float(), S["bits"], S["group"])[1])


@pytest.mark.parametrize("li, path", [(1, "experts.0.up_proj"), (2, "experts.1.down_proj")],
                         ids=["fed", "empty"])
def test_an_altered_code_of_a_routed_group_is_not_correct(moe, li, path):
    d, caps, check = _sweep(moe, SEEDS[0])
    mc = caps[li].modules[path]
    mc.codes = mc.codes.clone()
    mc.codes[0, 0] = 1 if mc.codes[0, 0] == 0 else mc.codes[0, 0] - 1
    ok, table = judge(check(caps), LIMITS)
    assert not ok and table["grid_miss"]["value"] >= 1, table


def test_one_capture_too_few_fails_the_alignment(moe):
    d, caps, check = _sweep(moe, SEEDS[0])
    caps[1].groups.pop(2)
    with pytest.raises(cq.CaptureMismatch, match="layer 1: the program factorized 3 groups"):
        check(caps)


def test_a_capture_of_another_width_fails_the_alignment(moe):
    d, caps, check = _sweep(moe, SEEDS[0])
    caps[1].groups[0], caps[1].groups[2] = caps[1].groups[2], caps[1].groups[0]
    caps[1].groups[2].h = torch.zeros((16, 16))
    with pytest.raises(cq.CaptureMismatch, match="layer 1 group 2"):
        check(caps)


def test_routed_groups_count_the_rows_that_fed_them(moe):
    d = moe.dims(CONF)
    h, ef, tokens, seq = 32, 32, 512, 64
    ranks, rows = [20, 12, 25, 0], [300, 212, 300, 212]
    fwd = 2 * (2 * h * tokens + (ef * h + h * ef) * (300 + 212))
    gram = h * h * 300 + h * h * 212 + ef * ef * 300 + ef * ef * 212
    f32 = sum(work.factor_flops(r) for r in ranks)
    f32 += sum(work.gptq_flops(m, n, r) for m, n, r in zip((ef, ef, h, h), (h, h, ef, ef), ranks))
    want = (fwd + gram) / 989e12 + f32 / 67e12
    assert work.quantize_layer_least_s(d, 1, tokens, seq, ranks, rows) == pytest.approx(want)
    with pytest.raises(ValueError, match="routed"):
        work.quantize_layer_least_s(d, 1, tokens, seq, ranks)
    # K2 runs on the quantized modules, not the router
    assert work.k2_layer_least_s(d, 1, 32, 32) == pytest.approx(
        2 * work.k2_launch_least_s(ef, 32, 32) + 2 * work.k2_launch_least_s(h, 32, 32))
    assert work.plan(d, 1).token_macs == 2 * h + 2 * ef * h
    assert work.model_macs(d) == 3 * 64 * h + 2 * (2 * h + 2 * ef * h)
    assert work.attention_layers(d) == 0


def test_the_driver_takes_a_routed_group_s_rows_from_the_log():
    rows = bench.driver("quantize-sweep")._rows
    routed, fed = Group(("experts.0.up_proj",), 32, routed=True), Group(("fc1",), 32)
    assert rows(routed, {"rank": 3, "rows": 17}, 512) == 17
    assert rows(routed, {"rank": 3}, 512) is None
    assert rows(fed, {"rank": 3}, 512) == 512

