"""The PyTorch port stands alone: importing `rustpotter_tpu_torch` loads
neither JAX nor the JAX package, and no source file of the port (or
chip_smoke.py, which runs its card tests) imports either."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "rustpotter_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "rustpotter_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    """Top-level names of every module `path` imports (relative imports
    resolve inside the port and are skipped)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_import_leaves_jax_and_the_jax_package_unloaded():
    code = (
        "import sys, json\n"
        "import rustpotter_tpu_torch\n"
        "import rustpotter_tpu_torch.runtime.convert, rustpotter_tpu_torch.synthetic\n"
        "import rustpotter_tpu_torch.runtime.detector, rustpotter_tpu_torch.ops.banded_dtw\n"
        "import rustpotter_tpu_torch.ops.dtw_dispatch, rustpotter_tpu_torch.wakewords.builder\n"
        "import rustpotter_tpu_torch.audio.encoder, rustpotter_tpu_torch.utils.wav\n"
        "import rustpotter_tpu_torch.utils.profiling, rustpotter_tpu_torch.native\n"
        "import rustpotter_tpu_torch.tools.kernel_probe, rustpotter_tpu_torch.tools.kernel_parity\n"
        "import rustpotter_tpu_torch.tools.fma_probe, rustpotter_tpu_torch.ops.biquad\n"
        "import rustpotter_tpu_torch.audio.filters, rustpotter_tpu_torch.audio.resampler\n"
        "import rustpotter_tpu_torch.audio.rustfft_f32, rustpotter_tpu_torch.wakewords.trainer\n"
        "import rustpotter_tpu_torch.parallel.dryrun\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, check=True, timeout=120,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "rustpotter_tpu_torch" in loaded
    # exact keys: "rustpotter_tpu_torch" shares the JAX package's prefix
    bad = [m for m in loaded if m in FORBIDDEN or m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    assert _imported_roots(path).isdisjoint(FORBIDDEN), path
