"""The PyTorch port stands alone: it imports with jax blocked, and neither a
module under src/repro_torch nor chip_smoke.py imports jax or the JAX
package."""
import os
import pathlib
import re
import subprocess
import sys

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"

MODULES = ["repro_torch.core.frame", "repro_torch.core.window",
           "repro_torch.core.dialect", "repro_torch.engine.session",
           "repro_torch.engine.lsm", "repro_torch.engine.ingest",
           "repro_torch.engine.index", "repro_torch.engine.distributed",
           "repro_torch.launch.mesh", "repro_torch.launch.hlocost",
           "repro_torch.launch.dryrun",
           "repro_torch.data.wisconsin", "repro_torch.kernels.ops",
           "repro_torch.kernels._build", "repro_torch.runtime.telemetry",
           "repro_torch.runtime.fault", "repro_torch.runtime.durable",
           "repro_torch.configs", "repro_torch.configs.paper_lm",
           "repro_torch.models.config", "repro_torch.models.layers",
           "repro_torch.models.attention", "repro_torch.models.transformer",
           "repro_torch.models.registry", "repro_torch.models.convert",
           "repro_torch.models.moe", "repro_torch.models.ssm",
           "repro_torch.models.hybrid", "repro_torch.models.hybrid_groups",
           "repro_torch.models.rwkv", "repro_torch.models.whisper",
           "repro_torch.models.steps", "repro_torch.models.optim",
           "repro_torch.models.sharding",
           "repro_torch.launch.serve", "repro_torch.launch.train",
           "repro_torch.runtime.tree", "repro_torch.runtime.checkpoint",
           "repro_torch.runtime.compress", "repro_torch.runtime.costs",
           "repro_torch.examples.quickstart",
           "repro_torch.examples.sentiment_pipeline",
           "repro_torch.examples.serve_model", "repro_torch.examples.train_lm",
           "repro_torch.udf.model_udf"]


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            + "".join(f"import {m}\n" for m in MODULES) +
            "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
            "sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env_path = str(PORT.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": env_path})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_module_imports_the_jax_package():
    pat = re.compile(r"^\s*(import\s+(repro|jax)\b|from\s+(repro|jax)[\s.])",
                     re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [p.name for p in files if pat.search(p.read_text())]
    assert not offenders, offenders
