"""CUDA graphs of the greedy decode chunk (``tgq_torch.serve.decode.DecodeGraphs``).

On the CPU: the rule that decides which chunks replay from a graph (a CUDA
device and greedy; the engine builds a holder only on a CUDA card outside a
mesh), the chunk lengths a holder captures, that it refuses a chunk it has
no graph of, and that a holder changes nothing where the rule says no
(``decode_steps`` stays eager, the CPU engine owns no holder and its graph
counters stay at 0).

On the card (``chip``, skipped here): graph tokens, KV writes and kernel
launch counts against the eager chunk at lengths 1, 2, 4 and 8, with a slot
that is not live, the engine with graphs against the engine without them
under speculation and slots retiring mid-chunk, and the returned block
apart from the graph's own.
"""
import pytest
import torch

from tgq_torch.core.quant import QuantSpec
from tgq_torch.kernels import dequant_matmul as KD
from tgq_torch.kernels import paged_attention as K5
from tgq_torch.models import PRESETS
from tgq_torch.models.hf_import import init_packed_params
from tgq_torch.serve import Engine, ServeConfig
from tgq_torch.serve.decode import (
    DecodeGraphs,
    decode_steps,
    fuse_packed_projections,
    graph_eligible,
    prefill_batch,
)
from tgq_torch.serve.kv_cache import PagedKVCache, PageTable

CFG = PRESETS["tiny-qwen3"]
CARD_CFG = PRESETS["tiny-qwen3-kv128"]   # head_dim 64: K5 takes 32 / 64 / 128 / 256
PROMPTS = [[5, 17, 42, 100, 7], [1, 2, 3], [10, 20, 30, 40, 50, 60], [99, 98]]
BUDGETS = [9, 14, 3, 20]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda", 0)


def packed_params(cfg, device):
    return fuse_packed_projections(
        init_packed_params(cfg, QuantSpec(bits=4, group_size=32), seed=0, device=device))


def prefilled(cfg, params, device, slots=4, prompt=12, steps=8, kv_bits=16):
    """(cache, page table, first tokens) after one greedy prefill of
    ``slots`` seeded prompts, with pages for ``steps`` more tokens."""
    page = 8
    mpps = -(-(prompt + steps + 1) // page)
    cache = PagedKVCache.init(cfg, slots * mpps + 1, page, kv_bits=kv_bits, device=device)
    pt = PageTable(slots * mpps + 1, page, slots, mpps, backend="python")
    gen = torch.Generator(device="cpu").manual_seed(1)
    pad = -(-prompt // page) * page
    ids = torch.zeros((slots, pad), dtype=torch.long)
    ids[:, :prompt] = torch.randint(0, cfg.vocab_size, (slots, prompt), generator=gen)
    pages = torch.tensor([pt.alloc_slot(s, prompt) for s in range(slots)])
    tok, cache = prefill_batch(params, cache, cfg, pages.to(device), ids.to(device),
                               torch.full((slots,), prompt, device=device),
                               torch.zeros((slots,), device=device), None, greedy_only=True)
    for s in range(slots):
        pt.extend(s, steps)
    return cache, pt, tok


def engine(params, cfg, device, **kw):
    base = dict(max_slots=2, page_size=8, num_pages=64, max_pages_per_slot=8,
                max_new_tokens=6, decode_chunk=8)
    return Engine(params, cfg, ServeConfig(**{**base, **kw}), device=device)


def launches():
    """K3, K4 and K5's launch counters."""
    return KD.launches, KD.launches_a8, K5.launches


def serve(eng, prompts, budgets=None):
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets or [None] * len(prompts))]
    eng.run()
    return [r.output for r in reqs]


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("device,greedy,ok", [
    ("cuda", True, True),
    ("cuda:0", True, True),
    ("cpu", True, False),
    ("cuda", False, False),   # temperature: the host's generator
    ("cpu", False, False),
])
def test_graph_eligible(device, greedy, ok):
    assert graph_eligible(torch.device(device), greedy) is ok


@pytest.mark.parametrize("decode_chunk,lengths", [(8, (1, 2, 4, 8)), (6, (1, 2, 4)),
                                                  (1, (1,)), (16, (1, 2, 4, 8, 16))])
def test_a_holder_captures_every_power_of_two_up_to_the_chunk(decode_chunk, lengths):
    g = DecodeGraphs({}, None, CFG, 3, 5, decode_chunk, "cpu")
    assert g.lengths == lengths
    assert g.table.shape == (3, 5) and g.table.dtype == torch.int32
    assert all(t.shape == (3,) and t.dtype == torch.int32
               for t in (g.lens, g.tokens, g.pos, g.live))


@pytest.fixture(scope="module")
def cpu_params():
    return packed_params(CFG, "cpu")


@pytest.mark.parametrize("n_steps,mpps", [(3, 8), (8, 8), (4, 4)])
def test_a_holder_refuses_a_chunk_it_has_no_graph_of(n_steps, mpps):
    g = DecodeGraphs({}, None, CFG, 2, 8, 4, "cpu")
    table, tokens = torch.zeros((2, mpps), dtype=torch.int32), torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(AssertionError, match="no graph of this chunk"):
        g.replay(table, tokens, tokens, tokens, None, n_steps)
    assert (g.replays, g.captures, g.graphs) == (0, 0, {})


def test_decode_steps_with_a_holder_on_the_cpu_stays_eager(cpu_params):
    toks = {}
    for with_graphs in (False, True):
        cache, pt, tok = prefilled(CFG, cpu_params, "cpu", slots=2, steps=4)
        lens0 = torch.tensor(pt.lens, dtype=torch.int32) - 4
        table, _ = pt.device_tables("cpu")
        g = DecodeGraphs(cpu_params, cache, CFG, 2, table.shape[1], 4, "cpu")
        out, cache = decode_steps(cpu_params, cache, CFG, table, lens0 + 1, tok, lens0,
                                  torch.zeros(2), None, 4, greedy_only=True,
                                  live=torch.ones(2, dtype=torch.int32),
                                  graphs=g if with_graphs else None)
        assert (g.replays, g.captures, g.graphs) == (0, 0, {})
        toks[with_graphs] = (out, cache.k.clone())
    assert torch.equal(toks[False][0], toks[True][0])
    assert torch.equal(toks[False][1], toks[True][1])


@pytest.mark.parametrize("overlap", [True, False])
def test_engine_counts_no_graph_chunk_on_the_cpu(cpu_params, overlap):
    eng = engine(cpu_params, CFG, "cpu", overlap_host=overlap)
    assert eng.graphs is None
    out = serve(eng, PROMPTS, BUDGETS)
    eager = engine(cpu_params, CFG, "cpu", overlap_host=overlap)
    eager.graphs = None
    assert serve(eager, PROMPTS, BUDGETS) == out
    assert [len(o) for o in out] == BUDGETS
    assert eng.chunks == eager.chunks > 0 and eng.spec_chunks == eager.spec_chunks
    assert (eng.graph_chunks, eng.graph_captures) == (0, 0)
    assert (eager.graph_chunks, eager.graph_captures) == (0, 0)


# ----------------------------------------------------------------- card


@pytest.mark.chip
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_graph_chunks_equal_eager_chunks_on_the_card(card, kv_bits):
    """Each length's replay gives the eager chunk's tokens, KV writes and
    kernel launch counts, with slot 2 not live (its pages must stay as they
    were)."""
    params = packed_params(CARD_CFG, card)
    live = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=card)
    for n in (1, 2, 4, 8):
        got = {}
        for with_graphs in (False, True):
            cache, pt, tok = prefilled(CARD_CFG, params, card, slots=4, steps=n,
                                       kv_bits=kv_bits)
            lens0 = torch.tensor(pt.lens, dtype=torch.int32, device=card) - n
            table, _ = pt.device_tables(card)
            g = DecodeGraphs(params, cache, CARD_CFG, 4, table.shape[1], 8, card)
            before = launches()
            out, cache = decode_steps(params, cache, CARD_CFG, table, lens0 + 1, tok, lens0,
                                      None, None, n, greedy_only=True, live=live,
                                      graphs=g if with_graphs else None)
            torch.cuda.synchronize()
            assert (g.replays, g.captures) == ((1, 4) if with_graphs else (0, 0))
            counted = tuple(b - a for a, b in zip(before, launches()))
            got[with_graphs] = (out.cpu(), cache.k.cpu(), cache.v.cpu(), counted)
        for a, b in zip(got[False][:3], got[True][:3]):
            assert torch.equal(a, b), n
        assert got[False][3] == got[True][3] and got[True][3][2] == n * CARD_CFG.num_layers, (
            n, got)


@pytest.mark.chip
def test_replayed_block_is_a_copy(card):
    params = packed_params(CARD_CFG, card)
    cache, pt, tok = prefilled(CARD_CFG, params, card, slots=4, steps=4)
    lens0 = torch.tensor(pt.lens, dtype=torch.int32, device=card) - 4
    table, _ = pt.device_tables(card)
    g = DecodeGraphs(params, cache, CARD_CFG, 4, table.shape[1], 4, card)
    live = torch.zeros(4, dtype=torch.int32, device=card)   # no KV write: replays alike
    first = g.replay(table, lens0 + 1, tok, lens0, live, 4)
    kept = first.clone()
    second = g.replay(table, lens0 + 1, tok.flip(0), lens0, live, 4)
    torch.cuda.synchronize()
    assert first.data_ptr() != g.out[4].data_ptr() != second.data_ptr()
    assert torch.equal(first, kept)


@pytest.mark.chip
@pytest.mark.parametrize("kv_bits,a_bits", [(16, 16), (8, 8), (4, 16)])
@pytest.mark.parametrize("overlap", [True, False])
def test_engine_with_graphs_serves_the_eager_tokens(card, kv_bits, a_bits, overlap):
    params = packed_params(CARD_CFG, card)
    kw = dict(max_slots=4, max_new_tokens=24, overlap_host=overlap, kv_bits=kv_bits,
              a_bits=a_bits)
    eager = engine(params, CARD_CFG, card, **kw)
    eager.graphs = None
    before = launches()
    want = serve(eager, PROMPTS * 2, BUDGETS * 2)
    eager_launches = tuple(b - a for a, b in zip(before, launches()))
    eng = engine(params, CARD_CFG, card, **kw)
    before = launches()
    assert serve(eng, PROMPTS * 2, BUDGETS * 2) == want
    assert tuple(b - a for a, b in zip(before, launches())) == eager_launches
    assert eng.graph_captures == 4
    assert eng.graph_chunks == eng.chunks == eager.chunks > 0
    assert eng.spec_chunks == eager.spec_chunks
    assert (eng.spec_chunks > 0) == overlap
