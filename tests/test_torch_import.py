"""The port stands alone: importing torchsnapshot_tpu_torch loads neither
JAX nor the JAX package, nor the dependencies the GPU host lacks."""

import json
import os
import re
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO_ROOT, "torchsnapshot_tpu_torch")
FORBIDDEN = ("jax", "ml_dtypes", "psutil", "aiofiles", "torchsnapshot_tpu")


def test_import_leaves_forbidden_modules_unloaded():
    code = (
        "import json, sys\n"
        "import torchsnapshot_tpu_torch\n"
        "import torchsnapshot_tpu_torch.snapshot\n"
        f"print(json.dumps([m for m in {FORBIDDEN!r} if m in sys.modules]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO_ROOT,
        capture_output=True,
        text=True,
        timeout=120,
        check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_none_of_the_forbidden_modules():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")(?:\s|\.|$)",
        re.MULTILINE,
    )
    offenders = []
    for dirpath, _, filenames in os.walk(PORT_DIR):
        for fname in filenames:
            if fname.endswith(".py"):
                path = os.path.join(dirpath, fname)
                with open(path) as f:
                    for m in pattern.finditer(f.read()):
                        offenders.append(f"{os.path.relpath(path, REPO_ROOT)}: {m.group(0).strip()}")
    assert offenders == []
