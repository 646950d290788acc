"""The port's sweep-layer CLIs end to end on the CPU: each of the six
diagram writers' ``main`` (``repro_torch.bench.*``) with ``--device cpu
--scenarios 1 --target-cs 5`` writes its JSON, CSV and Markdown, and the
reference's writer renders the port's JSON to the same bytes.  Without
``--device cpu`` and without CUDA each CLI raises before writing anything
(``tests/test_torch_kernel_contract.py``)."""

import importlib
import json
import warnings

import pytest
import torch

torch.set_num_threads(1)

#: CLI module -> the stem of its CSV / Markdown report.
CLIS = {
    "oracle_ablation": "oracle_phase_diagram",
    "discipline_diagram": "discipline_phase_diagram",
    "workload_diagram": "workload_phase_diagram",
    "arrival_diagram": "arrival_phase_diagram",
    "fault_diagram": "fault_phase_diagram",
    "park_diagram": "park_phase_diagram",
}


@pytest.mark.parametrize("name,extra", [
    ("oracle_ablation", []),
    ("discipline_diagram", []),
    ("discipline_diagram", ["--backend", "ref", "--stream", "on"]),
    ("workload_diagram", []),
    ("arrival_diagram", []),
    ("fault_diagram", []),
    ("park_diagram", []),
])
def test_cli_writes_its_reports_on_the_cpu(name, extra, tmp_path):
    port = importlib.import_module(f"repro_torch.bench.{name}")
    ref = importlib.import_module(f"benchmarks.{name}")
    out = tmp_path / f"{name}.json"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = port.main(["--device", "cpu", "--scenarios", "1",
                            "--target-cs", "5", "--out", str(out)] + extra)
    meta = result["meta"]
    assert meta["n_scenarios"] == 1 and meta["device"] == "cpu"
    assert meta["streamed"] is ("on" in extra)
    assert meta["backend"] == ("ref" if "ref" in extra else "kernel")
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    csv = (tmp_path / f"{CLIS[name]}.csv").read_bytes()
    md = (tmp_path / f"{CLIS[name]}.md").read_bytes()
    assert csv.count(b"\n") == 1 + len(result["phase"])
    assert sum(c["n"] for c in result["phase"]) == \
        meta["n_configs"] // meta["n_variants"]
    assert len(md) > 0
    csv_ref, md_ref = ref.write_phase_diagram(
        json.loads(out.read_text()), str(tmp_path / "ref"))
    with open(csv_ref, "rb") as f, open(md_ref, "rb") as g:
        assert (f.read(), g.read()) == (csv, md)


def test_auto_scenarios_counts_one_card():
    """The reference's count on a one-device host: ``base``, capped."""
    from benchmarks.discipline_diagram import auto_scenarios as jauto
    from repro_torch.bench.discipline_diagram import auto_scenarios

    for base, n_variants in ((200, 15), (100, 60), (50, 120), (24, 15),
                             (10, 20_000)):
        assert auto_scenarios(base, n_variants) == jauto(base, n_variants)
