"""The port stands alone: no JAX, nothing of the reference package, and no
library kernels inside its CUDA sources."""

import ast
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PY_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
CUDA_FILES = sorted(PORT.rglob("*.cu")) + sorted(PORT.rglob("*.cuh"))


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_cuda_sources_call_no_library_kernels():
    assert {p.name for p in CUDA_FILES} >= {"ptr_step.cu", "ptr_decode.cu", "ptr_common.cuh",
                                            "flash_fwd.cu", "ssd_scan.cu"}
    pattern = re.compile(r"cublas|cudnn|cutlass|cufft|thrust|cub/|torch", re.IGNORECASE)
    for path in CUDA_FILES:
        for line in path.read_text().splitlines():
            code = line.split("//")[0]
            assert not pattern.search(code), f"{path.name}: {line.strip()}"


def test_port_runs_with_jax_unimportable(tmp_path):
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of jax now raises
        import numpy as np
        import repro_torch
        from repro_torch.core import RespectScheduler, sample_dag
        sched = RespectScheduler.from_release(device="cpu")
        g = sample_dag(np.random.default_rng(0), n=20, deg=3)
        res = sched.schedule_many([g, g], 4)
        assert res[0]["assignment"].shape == (20,) and res[1]["cache_hit"]
        import repro_torch.serving
        with repro_torch.serving.SchedulerService(sched) as svc:
            served = svc.submit(g, 4).result(timeout=60)
        assert served["served_by"] == "policy" and served["cache_hit"]
        assert (served["assignment"] == res[0]["assignment"]).all()
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.models.model import build_model
        model = build_model(get_smoke_config("zamba2-7b"), device="cpu")
        logits, cache = model.prefill(model.init_params(0),
                                      {"tokens": torch.zeros((1, 10), dtype=torch.long)})
        assert logits.shape == (1, 1, 256) and bool(torch.isfinite(logits.float()).all())
        import repro_torch.eval.__main__
        import repro_torch.train_release
        from repro_torch.core import postprocess
        from repro_torch.eval import ExactOracle, hetero_grid, run_scenario
        sc = hetero_grid(smoke=True)[1]                      # memcap/k2
        rec = run_scenario(sc, sched, ExactOracle(device="cpu"))
        assert rec["oracle"]["parity"] and rec["policies"]["respect"]["all_capacity_ok"]
        assert postprocess.repair(g, res[0]["assignment"], 4).shape == (20,)
        import repro_torch.ingest
        ing = repro_torch.ingest.ingest_model("whisper-tiny", n_nodes=12)   # smoke config
        assert ing.report["n_warnings"] == 0 and 2 <= ing.graph.n <= 12
        assert ing.report["param_bytes_total"] == 433152.0
        import json
        from repro_torch.train_lm import main as train_lm
        assert train_lm(["--arch", "whisper-tiny", "--device", "cpu", "--steps", "1",
                         "--batch", "2", "--seq", "16", "--ckpt-dir", TMP + "/ck",
                         "--metrics", TMP + "/m.jsonl"]) == 0
        rec = json.loads(open(TMP + "/m.jsonl").read())
        assert rec["step"] == 1 and np.isfinite(rec["loss"]) and rec["grad_norm"] > 0
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", f"TMP = {str(tmp_path)!r}\n" + script],
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_without_cuda_or_outside_a_checkout(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": ""}
    for script in (ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py"):
        if script.parent == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             env=env, cwd=script.parent, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
