"""``python -m tgq_torch.cli.serve`` on the CPU at tiny size: the metrics
dict of ``tgq/cli/serve.py``'s ``run``, the checkpoint and preset load
paths, the packed head, and the flags that were queued."""
import json

import numpy as np
import pytest
import torch

from tgq_torch.cli.serve import build_parser, main, run

TINY = ["--model_id", "tiny-qwen3", "--device", "cpu", "--n_requests", "4",
        "--prompt_len", "12", "--gen_tokens", "5", "--max_slots", "2", "--page_size", "8",
        "--group_size", "32"]
KEYS = {"metric", "value", "unit", "total_tokens", "wall_s", "decode_wall_s",
        "prefill_wall_s", "decode_only_tok_s", "ttft_p50_s", "ttft_p90_s", "ttft_p99_s",
        "arrival_rate", "config"}


@pytest.mark.parametrize("extra", [[], ["--kv_bits", "8", "--a_bits", "8"],
                                   ["--kv_bits", "4", "--w_bits", "3", "--decode_chunk", "2"]])
def test_run_metrics(extra):
    res = run(build_parser().parse_args(TINY + extra))
    assert set(res) >= KEYS
    assert res["total_tokens"] == 4 * 5
    assert res["value"] > 0 and np.isfinite(res["ttft_p99_s"])
    assert res["config"]["a_bits"] == (8 if "--a_bits" in extra else 16)
    assert res["config"]["device"] == "cpu"


def test_main_prints_json(capsys):
    assert main(TINY + ["--arrival_rate", "200"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["arrival_rate"] == 200 and res["total_tokens"] == 20


def test_packed_head_and_dense_weights():
    from tgq_torch.cli.serve import load_or_make_model
    from tgq_torch.core.packing import PackedLinear

    args = build_parser().parse_args(["--model_id", "tiny-llama", "--device", "cpu",
                                      "--group_size", "32", "--lm_head_bits", "8",
                                      "--w_bits", "16"])
    params, cfg, _ = load_or_make_model(args, torch.device("cpu"))
    head = params["lm_head"]
    assert isinstance(head, PackedLinear) and head.out_features % 512 == 0
    assert isinstance(params["model"]["layers"][0]["mlp"]["down_proj"], dict)
    res = run(build_parser().parse_args(
        ["--model_id", "tiny-llama", "--device", "cpu", "--n_requests", "2", "--prompt_len",
         "6", "--gen_tokens", "3", "--max_slots", "2", "--page_size", "8", "--group_size",
         "32", "--lm_head_bits", "8"]))
    assert res["total_tokens"] == 6


def test_checkpoint_path(tmp_path):
    """A packed checkpoint written by the port's quantizer serves."""
    from tgq_torch.calib import QuantizeConfig, quantize_model
    from tgq_torch.core.checkpoint import save_quantized
    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import init_params

    cfg = PRESETS["tiny-qwen3"]
    params = init_params(cfg, device="cpu")
    qcfg = QuantizeConfig(mode="rtn", w_bits=4, group_size=32)
    params, packed, _ = quantize_model(params, cfg, np.zeros((2, 16), np.int32), qcfg,
                                       device="cpu")
    save_quantized(str(tmp_path), params, packed, cfg, {"w_bits": 4})
    res = run(build_parser().parse_args(
        ["--checkpoint", str(tmp_path), "--device", "cpu", "--n_requests", "2",
         "--prompt_len", "6", "--gen_tokens", "3", "--max_slots", "2", "--page_size", "8"]))
    assert res["total_tokens"] == 6 and res["config"]["model"] == "tiny-qwen3"


@pytest.mark.parametrize("flag", [["--mesh_model", "2"], ["--mesh_data", "2"], ["--distributed"],
                                  ["--kv_equalize"], ["--profile_dir", "x"]])
def test_queued_flags_raise(flag, tmp_path, capsys, monkeypatch):
    """The once-queued flags run: a trace of the measured run, equalizers
    calibrated for an int8 cache (and none for bf16 KV, as in the JAX CLI),
    and the mesh flags — ``--mesh_model 2`` on two ranks the command starts
    itself, ``--mesh_data 2`` as two replicas, ``--distributed`` as a world
    of one from torchrun's environment variables."""
    if flag[0] in ("--mesh_model", "--mesh_data"):
        extra = ["--mesh_model", "1"] if flag[0] == "--mesh_data" else []
        assert main(TINY + flag + extra) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        par = res["config"]["parallel"]
        assert res["total_tokens"] == 20
        assert (par["data"], par["model"]) == ((1, 2) if not extra else (2, 1))
        assert par["backend"] == "gloo"
        assert (par["collectives"] > 0) == (par["model"] > 1)   # replicas talk only at start
        return
    if flag[0] == "--distributed":
        import torch.distributed as dist

        from tgq_torch.parallel.launch import free_port

        for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                         MASTER_ADDR="localhost", MASTER_PORT=str(free_port())).items():
            monkeypatch.setenv(k, v)
        try:
            res = run(build_parser().parse_args(TINY + flag + ["--mesh_model", "1"]))
            assert dist.is_initialized() and dist.get_world_size() == 1
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        assert res["total_tokens"] == 20
        assert res["config"]["parallel"]["model"] == 1
        return
    if flag[0] == "--kv_equalize":
        for kv, want in (("8", "calibrated"), ("16", None)):
            res = run(build_parser().parse_args(TINY + flag + ["--kv_bits", kv]))
            assert res["total_tokens"] == 20 and res["config"]["kv_equalizers"] == want
        return
    if flag[0] == "--profile_dir":
        res = run(build_parser().parse_args(TINY + ["--profile_dir", str(tmp_path / "x")]))
        assert res["total_tokens"] == 20
        trace = json.load(open(tmp_path / "x" / "trace.json"))
        assert trace["traceEvents"]
        return
    raise AssertionError(f"no case for {flag}")


def test_mesh_open_loop(capsys):
    """``--mesh_model 2`` with Poisson arrivals: the first rank's clock
    decides which requests each step admits and broadcasts the count, so
    both ranks take the same steps (a rank admitting on its own clock
    could prefill while the other decodes, and their collectives would
    not match).  With ``--time_collectives`` the decode collectives are
    counted and timed apart from the prefill's, the wait for the other
    rank apart from the collective itself."""
    assert main(TINY + ["--mesh_model", "2", "--arrival_rate", "100",
                        "--time_collectives"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    c, par = res["config"], res["config"]["parallel"]
    assert res["total_tokens"] == 20 and res["arrival_rate"] == 100
    assert c["rank_decode_steps"][0] == c["rank_decode_steps"][1] == c["decode_steps"]
    by = par["collectives_by_phase"]
    assert by["other"]["calls"] > 0          # the admission broadcasts
    assert by["prefill"]["calls"] > 0 and by["decode"]["calls"] > 0
    assert par["collectives"] == sum(p["calls"] for p in by.values())
    assert par["decode_collectives_per_step"] == round(
        by["decode"]["calls"] / c["decode_steps"], 2)
    assert par["decode_collective_ms_per_step"] > 0
    assert par["decode_collective_wait_ms_per_step"] >= 0
    assert by["decode"]["wait_ms"] is not None and by["prefill"]["ms"] > 0


def test_hf_path_raises(tmp_path, monkeypatch):
    """A hub id that is not in the local HF cache raises ValueError."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    with pytest.raises(ValueError, match="not in the local HF cache"):
        run(build_parser().parse_args(["--model_id", "Qwen/Qwen3-8B", "--device", "cpu"]))


def test_local_hf_directory_serves(tmp_path):
    """A local HF checkpoint directory (llama family) serves, RTN-packed on
    load; a GPT-2 one is refused by the engine, as in the JAX package."""
    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import init_params
    from tgq_torch.models.hf_export import export_hf

    for name in ("tiny-qwen3", "tiny-gpt2"):
        cfg = PRESETS[name]
        export_hf(str(tmp_path / name), init_params(cfg, device="cpu"), cfg)
    argv = ["--device", "cpu", "--n_requests", "2", "--prompt_len", "6", "--gen_tokens", "3",
            "--max_slots", "2", "--page_size", "8", "--group_size", "32"]
    res = run(build_parser().parse_args(argv + ["--model_id", str(tmp_path / "tiny-qwen3")]))
    assert res["total_tokens"] == 6
    with pytest.raises(NotImplementedError, match="llama-family"):
        run(build_parser().parse_args(argv + ["--model_id", str(tmp_path / "tiny-gpt2")]))
