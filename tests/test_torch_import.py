"""The port stands alone: importing torchsnapshot_tpu_torch loads neither
JAX nor the JAX package, nor the dependencies the GPU host lacks."""

import json
import os
import re
import subprocess
import sys

from torch_env import default_knob_env  # noqa: F401  autouse fixture

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO_ROOT, "torchsnapshot_tpu_torch")
FORBIDDEN = (
    "jax",
    "ml_dtypes",
    "psutil",
    "aiofiles",
    "zstandard",
    "lz4",
    "requests",
    "google.resumable_media",
    "google.auth.transport.requests",
    "torchsnapshot_tpu",
)


def test_import_leaves_forbidden_modules_unloaded():
    code = (
        "import json, sys\n"
        "import torchsnapshot_tpu_torch\n"
        "import torchsnapshot_tpu_torch.snapshot\n"
        "import torchsnapshot_tpu_torch.device_staging\n"
        "import torchsnapshot_tpu_torch.preemption\n"
        "import torchsnapshot_tpu_torch.rss_profiler\n"
        "import torchsnapshot_tpu_torch.dist_store\n"
        "import torchsnapshot_tpu_torch.tpustore\n"
        "import torchsnapshot_tpu_torch.coordination\n"
        "import torchsnapshot_tpu_torch.pg_wrapper\n"
        "import torchsnapshot_tpu_torch.partitioner\n"
        "import torchsnapshot_tpu_torch.manifest_ops\n"
        "import torchsnapshot_tpu_torch.manifest_utils\n"
        "import torchsnapshot_tpu_torch.io_preparers.sharded_array\n"
        "import torchsnapshot_tpu_torch.test_utils\n"
        "import torchsnapshot_tpu_torch.faults\n"
        "import torchsnapshot_tpu_torch.compression\n"
        "import torchsnapshot_tpu_torch.memoryview_stream\n"
        "import torchsnapshot_tpu_torch.chunker\n"
        "import torchsnapshot_tpu_torch.cas\n"
        "import torchsnapshot_tpu_torch.incremental\n"
        "import torchsnapshot_tpu_torch.journal\n"
        "import torchsnapshot_tpu_torch.manager\n"
        "import torchsnapshot_tpu_torch.replication\n"
        "import torchsnapshot_tpu_torch.__main__\n"
        "import torchsnapshot_tpu_torch.telemetry\n"
        "import torchsnapshot_tpu_torch.telemetry.sidecar\n"
        "import torchsnapshot_tpu_torch.telemetry.history\n"
        "import torchsnapshot_tpu_torch.native_io\n"
        "import torchsnapshot_tpu_torch._native.build\n"
        "import torchsnapshot_tpu_torch.storage_plugins.fs\n"
        "import torchsnapshot_tpu_torch.storage_plugins.s3\n"
        "import torchsnapshot_tpu_torch.storage_plugins.gcs\n"
        "import torchsnapshot_tpu_torch.storage_plugins._ranged\n"
        "from torchsnapshot_tpu_torch import compression\n"
        "assert compression.resolve('zstd') == 'zstd'  # the native backend\n"
        "compression.decode(compression.encode(bytes(1 << 21), 'zstd')[0])\n"
        "compression.decode(compression.encode(bytes(1 << 16), 'zlib')[0])\n"
        "assert compression.resolve('lz4') == 'raw'\n"
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
