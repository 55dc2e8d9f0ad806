"""The port's doctor (`mdi_llm_tpu_torch/cli/doctor.py`) on the CPU.

Injected stub stages pin the per-stage subprocess machinery as
`tests/test_doctor.py` does for the JAX doctor: a wedged stage comes
back as "timeout", fast, with the tool alive; a crash keeps its error
tail; a skip and the payload parse; the snapshot's schema and health.
The stage bodies run in this process where they need no card (`--device
cpu` pins them; without a card `devices` and `kernels` fail, never
skip).  One real `--quick --device cpu` run spawns the three bring-up
interpreters: spawned interpreters are the slow part of the tier-1 run.
"""

import json
import time

import pytest
import torch

from mdi_llm_tpu_torch.cli import doctor

torch.set_num_threads(1)


def _stage(name, code, timeout=5.0):
    return {"name": name, "help": name, "timeout": timeout, "quick": True, "code": code}


def test_wedged_stage_hits_its_timeout_without_hanging_the_tool():
    wedge = _stage("wedge", "import time; time.sleep(30)", timeout=0.5)
    t0 = time.perf_counter()
    rec = doctor.run_stage(wedge)
    assert rec["status"] == "timeout" and time.perf_counter() - t0 < 10.0
    assert rec["timeout_s"] == 0.5 and "killed" in rec["error"]
    assert rec["elapsed_s"] >= 0.5


def test_failed_skipped_and_ok_stages():
    rec = doctor.run_stage(_stage("boom", "raise RuntimeError('kaboom')"))
    assert rec["status"] == "failed" and "kaboom" in rec["error"]
    rec = doctor.run_stage(_stage("skip", "import json; print(json.dumps({'skipped': 'n/a'}))"))
    assert rec["status"] == "skipped"
    rec = doctor.run_stage(_stage("ok", "import json; print('noise'); "
                                        "print(json.dumps({'answer': 42}))"))
    assert rec["status"] == "ok" and rec["detail"]["answer"] == 42
    # the stage's environment: the device pin and the checkout on the path
    rec = doctor.run_stage(_stage("env", "import json, os, mdi_llm_tpu_torch; print(json.dumps("
                                         "{'d': os.environ['MDI_DOCTOR_DEVICE']}))"),
                           env={doctor.DEVICE_ENV: "cpu"})
    assert rec["status"] == "ok" and rec["detail"] == {"d": "cpu"}


def test_snapshot_schema_with_stub_stages():
    stages = [
        _stage("dev", "import json; print(json.dumps({'platform': 'gpu', "
                      "'device_kind': 'NVIDIA H100 80GB HBM3', 'device_count': 1}))"),
        _stage("wedge", "import time; time.sleep(30)", timeout=0.5),
    ]
    snap = doctor.collect_snapshot(stages=stages)
    assert snap["schema"] == doctor.SCHEMA_VERSION and snap["ok"] is False
    assert (snap["backend"], snap["device_kind"], snap["device_count"]) == (
        "gpu", "NVIDIA H100 80GB HBM3", 1)
    assert [r["name"] for r in snap["stages"]] == ["dev", "wedge"]
    assert snap["stages"][1]["status"] == "timeout"
    assert "versions" in snap and "hostname" in snap and "env" in snap
    json.dumps(snap)
    t0 = time.perf_counter()
    snap2 = doctor.collect_snapshot(stages=[stages[1]], stage_timeout=0.3)
    assert snap2["stages"][0]["timeout_s"] == 0.3 and time.perf_counter() - t0 < 10.0


def test_unhealthy_snapshot_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(doctor, "STAGES", [_stage("boom", "raise SystemExit(3)")])
    assert doctor.main([]) == 1
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert snap["ok"] is False


def test_provenance_is_cheap_and_probe_scoped():
    prov = doctor.provenance()
    assert prov["versions"]["torch"] == torch.__version__
    assert prov["hostname"] and prov["python"]
    assert all(k.startswith(("CUDA_", "NVIDIA_", "NCCL_", "TORCH_", "PYTORCH_", "MDI_"))
               for k in prov["env"])
    json.dumps(prov)


def test_cli_surface(capsys):
    help_text = doctor.build_parser().format_help()
    for flag in ("--quick", "--stage-timeout", "--json", "--device", "--list-stages"):
        assert flag in help_text
    assert [s["name"] for s in doctor.STAGES] == [
        "import_torch", "devices", "matmul", "kernels", "graph", "profiler_trace",
        "collective", "threads"]
    assert [s["name"] for s in doctor.STAGES if s["quick"]] == [
        "import_torch", "devices", "matmul"]
    assert doctor.main(["--list-stages"]) == 0
    assert "kernels" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the stage bodies, in this process
# ---------------------------------------------------------------------------


def test_the_card_stages_fail_without_a_card_unless_the_cpu_is_asked_for():
    """No card here: `devices` and `kernels` fail on "cuda" (never skip);
    on "cpu" the card's stages skip with their reason."""
    with pytest.raises(RuntimeError, match="is_available"):
        doctor._devices("cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        doctor._kernels("cuda")
    assert doctor._devices("cpu") == {"platform": "cpu", "device_kind": "cpu",
                                      "device_count": 1}
    for stage in (doctor._kernels, doctor._graph, doctor._collective):
        assert "skipped" in stage("cpu")


def test_cpu_stage_bodies():
    m = doctor._matmul("cpu")
    assert m["correct"] is True and m["max_abs_err"] == 0.0
    t = doctor._profiler_trace("cpu")
    assert t["n_events"] > 0 and t["trace_bytes"] > 0
    b = doctor._threads("cpu")
    assert b["ok"] is True and b["mismatches"] == [] and b["yield_point_visits"] > 0


def test_quick_triage_healthy_on_cpu(tmp_path, capsys):
    out_p = tmp_path / "doctor.json"
    assert doctor.main(["--quick", "--device", "cpu", "--json", str(out_p)]) == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert snap["ok"] is True and json.loads(out_p.read_text())["ok"] is True
    assert [r["name"] for r in snap["stages"]] == ["import_torch", "devices", "matmul"]
    assert all(r["status"] == "ok" for r in snap["stages"])
    assert snap["backend"] == "cpu" and snap["device_kind"] == "cpu"
    assert snap["stages"][0]["detail"]["torch"] == torch.__version__
    assert snap["stages"][2]["detail"]["correct"] is True
