"""``python -m tgq_torch.cli.quantize`` against ``tgq.cli.quantize``: the
same flags and defaults (but --device and --kernel_backend), and a
results.json with the JAX CLI's keys."""
import json
import os

import numpy as np
import pytest

TINY = ["--model_id", "tiny-qwen3", "--dataset", "synthetic", "--n_samples", "4",
        "--seq_len", "64", "--batch_size", "2", "--group_size", "-1",
        "--block_size", "32", "--attn_impl", "naive", "--mode", "pchol",
        "--w_bits", "4", "--eps", "1e-7"]


def test_flags_match_jax():
    from tgq.cli.args import build_parser as jparser
    from tgq_torch.cli.args import build_parser as tparser

    ja = {a.dest: a for a in jparser()._actions}
    ta = {a.dest: a for a in tparser()._actions}
    assert set(ta) == set(ja)
    for dest, a in ja.items():
        if dest in ("device", "kernel_backend", "help"):
            continue
        assert ta[dest].default == a.default, dest
        assert ta[dest].choices == a.choices, dest
    assert ta["device"].default == "cuda" and ta["device"].choices == ["cuda", "cpu"]
    assert ta["kernel_backend"].default == "kernel"
    assert ta["kernel_backend"].choices == ["kernel", "plain"]


def test_cli_results_match_jax_keys(tmp_path):
    from tgq.cli.quantize import main as jmain
    from tgq_torch.cli.quantize import main as tmain

    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    assert jmain(TINY + ["--save_path", jout, "--device", "cpu"]) == 0
    assert tmain(TINY + ["--save_path", tout, "--device", "cpu"]) == 0
    jres = json.load(open(os.path.join(jout, "results.json")))
    tres = json.load(open(os.path.join(tout, "results.json")))
    assert set(tres) == set(jres)
    assert set(tres["config"]) == set(jres["config"])
    assert set(tres["metrics"]) == set(jres["metrics"])
    assert set(tres["metrics"]["phase_timing"]) == set(jres["metrics"]["phase_timing"])
    assert [s["name"] for s in tres["layer_stats"]] == [s["name"] for s in jres["layer_stats"]]
    assert all(set(t) >= set(j) for t, j in zip(tres["layer_stats"], jres["layer_stats"]))
    assert np.isfinite(tres["metrics"]["quantized_ppl"])
    for f in ("weights.npz", "config.json", "quantization.log"):
        assert os.path.exists(os.path.join(tout, f)), f


def test_cli_baseline_mode(tmp_path):
    from tgq_torch.cli.quantize import main

    out = str(tmp_path / "base")
    assert main(TINY + ["--mode", "baseline", "--device", "cpu", "--save_path", out]) == 0
    res = json.load(open(os.path.join(out, "results.json")))
    assert np.isfinite(res["metrics"]["baseline_ppl"])


@pytest.mark.parametrize("extra", [["--resume_dir", "r"], ["--kv_equalize"], ["--hf_export"],
                                   ["--profile_dir", "p"], ["--mode", "test"]])
def test_later_slice_flags_raise(tmp_path, extra):
    """The flags a later slice ported now run (each leaves its artifact);
    --kv_equalize is still queued and raises."""
    from tgq_torch.cli.quantize import main

    out = tmp_path / "o"
    argv = TINY + ["--device", "cpu", "--save_path", str(out)]
    if extra == ["--kv_equalize"]:
        with pytest.raises(NotImplementedError, match="queued"):
            main(argv + extra)
        return
    extra = [str(tmp_path / e) if e in ("r", "p") else e for e in extra]
    assert main(argv + extra) == 0
    res = json.load(open(out / "results.json"))
    if "--mode" in extra:
        assert len(res["spectral_check"]) == 4 and not res["layer_stats"]
        assert all(np.isfinite(r["ratio"]) for r in res["spectral_check"])
        return
    assert len(res["layer_stats"]) == 14 and np.isfinite(res["metrics"]["quantized_ppl"])
    artifact = {"--resume_dir": tmp_path / "r" / "progress.json",
                "--hf_export": out / "hf" / "model.safetensors",
                "--profile_dir": tmp_path / "p" / "trace.json"}[extra[0]]
    assert artifact.exists(), artifact


def test_hf_model_id_raises(tmp_path):
    """A local directory without a checkpoint raises; a local HF
    checkpoint directory quantizes."""
    from tgq_torch.cli.quantize import main
    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import init_params
    from tgq_torch.models.hf_export import export_hf

    with pytest.raises(FileNotFoundError):
        main(["--model_id", str(tmp_path), "--device", "cpu",
              "--save_path", str(tmp_path / "o")])
    cfg = PRESETS["tiny-qwen3"]
    export_hf(str(tmp_path / "hf"), init_params(cfg, device="cpu"), cfg)
    argv = TINY[2:] + ["--model_id", str(tmp_path / "hf"), "--device", "cpu",
                       "--save_path", str(tmp_path / "q")]
    assert main(argv) == 0
    res = json.load(open(tmp_path / "q" / "results.json"))
    assert len(res["layer_stats"]) == 14 and np.isfinite(res["metrics"]["quantized_ppl"])
