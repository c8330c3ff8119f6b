"""A cell, configuration, family, mix and per-layer metric added as new
files and a BENCHMARK.json entry are found with no edit to an existing
file, and nothing outside ``families/`` branches on a family."""
import ast
import json
import shutil

import pytest

from portbench.lib import bench


def _copy_tree(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(bench.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(bench.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_new_cell_is_found_by_its_files(tmp_path):
    root = _copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    pkg = root / "portbench"
    conf = json.loads((pkg / "configs" / "qwen3-8b.json").read_text())
    conf["num_hidden_layers"] = 28
    (pkg / "configs" / "new-model.json").write_text(json.dumps(conf))
    mix = json.loads((pkg / "traffic" / "decode-closed-128.json").read_text())
    mix["clients"] = mix["slots"] = 64
    (pkg / "traffic" / "decode-closed-64.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "engine.steps_per_s.py").write_text(
        "def read(rec):\n    return rec['steps'] / rec['window_s']\n")
    (pkg / "limits" / "new-model.decode-64.json").write_text('{"served_gap": 1.0}')
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "new-model", "source": "https://example.org/new",
                         "file": "portbench/configs/new-model.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "new-model.decode-64", "config": "new-model",
                           "traffic": "decode-closed-64", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "output_tok_s":
            m["workloads"].append("new-model.decode-64")
    b["per_layer"].append({"name": "engine.steps_per_s", "unit": "steps/s", "better": "higher",
                           "source": "program_counter", "layer": "serve.engine.Engine",
                           "moves": "output_tok_s", "workloads": ["new-model.decode-64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = bench.find_cell("new-model.decode-64", root)
    assert cell.config["num_hidden_layers"] == 28 and cell.mix["clients"] == 64
    assert cell.limits == {"served_gap": 1.0}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "output_tok_s"}
    assert [m["name"] for m in cell.per_layer if m["name"] == "engine.steps_per_s"]
    reader = bench.load_module(root / "portbench" / "metrics" / "engine.steps_per_s.py")
    assert reader.read({"steps": 30, "window_s": 10.0}) == 3.0
    assert bench.load_module(root / "portbench" / "drivers" / "serve-closed.py").run
    # no file that was there changed
    assert all(p.read_bytes() == data for p, data in before.items())


def test_every_cell_of_the_benchmark_resolves():
    b = bench.load_json(bench.ROOT / "BENCHMARK.json")
    for w in b["workloads"]:
        cell = bench.find_cell(w["name"])
        assert bench.driver(cell.mix["driver"]).run
        assert cell.limits, f"{w['name']} has no limits file"
        for m in cell.per_layer:
            assert bench.reader(m["name"]).read
        fam = bench.family(cell.config["family"])
        assert fam.layer_plan(fam.dims(cell.config), 0).groups
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def _file(metric):
    return bench.reader(metric).read.__code__.co_filename


def test_a_split_metric_name_finds_the_reader_of_its_base():
    for name in ("device.idle_share.quantize", "device.idle_share.serve-decode",
                 "device.idle_share.some-new-cell"):
        assert _file(name).endswith("/metrics/device.idle_share.py")
    assert _file("mfu.serve-prefill").endswith("/metrics/mfu.serve.py")
    assert _file("mfu.quantize").endswith("/metrics/mfu.quantize.py")


def test_no_harness_file_outside_families_names_a_family():
    """No file under ``portbench/`` outside ``families/`` and ``tests/``
    holds a family's name as a string or tests ``family ==``."""
    names = {p.stem for p in (bench.PKG / "families").glob("*.py")}
    assert {"llama", "opt"} <= names
    for path in bench.PKG.rglob("*.py"):
        if path.relative_to(bench.PKG).parts[0] in ("families", "tests"):
            continue
        text = path.read_text()
        assert "family ==" not in text and "family !=" not in text, path
        strings = {n.value for n in ast.walk(ast.parse(text))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        assert not strings & names, (path, strings & names)


def test_an_unknown_family_names_its_missing_file():
    from portbench.lib.runctx import model_config
    with pytest.raises(FileNotFoundError, match=r"families/no_such_family\.py"):
        bench.family("no_such_family")
    with pytest.raises(FileNotFoundError, match=r"families/no_such_family\.py"):
        model_config({"family": "no_such_family"}, "x")


def test_a_new_reader_sees_the_log_a_phase_and_a_program_span(tmp_path, monkeypatch):
    """A reader added as one file reads a key of the quantize log, a phase
    and a ``tgq.*`` span the program opens (planted here, as a later change
    to the program would add one)."""
    from tgq_torch.calib import pipeline
    from tgq_torch.utils import profiling

    from portbench.tests import tiny
    root = _copy_tree(tmp_path)
    pkg = root / "portbench"
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    (pkg / "metrics" / "calib.new_reading.py").write_text(
        "def read(rec):\n"
        "    span = rec['trace']['program'].get('tgq.calib.layer')\n"
        "    if span is None or 'factorize' not in rec['phase_s']:\n"
        "        return None\n"
        "    return 1000 * span['count'] + sum(m['rank'] for m in rec['log']['layer_stats'])\n")
    real = pipeline.quantize_layer

    def spanned(*args, **kwargs):
        with profiling.span("calib.layer"):
            return real(*args, **kwargs)
    monkeypatch.setattr(pipeline, "quantize_layer", spanned)
    c = tiny.cell("qwen3-8b.quantize", tiny.QWEN, tiny.SWEEP)
    c.per_layer = c.per_layer + [{"name": "calib.new_reading", "unit": "x", "better": "higher",
                                  "source": "program_span", "layer": "calib.pipeline",
                                  "moves": "quantize_s_per_layer"}]
    out = tiny.run(c, trace=True)
    monkeypatch.setattr(bench, "PKG", pkg)
    got = bench.per_layer_values(c, out.rec, out.trace)["calib.new_reading"]["value"]
    layers = out.rec["traced_sweeps"] * out.rec["layers_per_sweep"]
    assert layers > 0
    assert got == 1000 * layers + sum(m["rank"] for m in out.rec["log"]["layer_stats"])
    assert all(p.read_bytes() == data for p, data in before.items())
