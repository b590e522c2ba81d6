"""The port's native host library loader: keyed by source, flags and host
CPU, and it raises when it cannot build (there is no fallback)."""

import os
import subprocess
import sys
from pathlib import Path

from iggt_official_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent


def test_library_is_keyed_by_host_cpu_and_flags(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(native, "_cpu_key", lambda: "another CPU")
    other_cpu = native.library_path()
    monkeypatch.setattr(native, "FLAGS", native.FLAGS[:-1])
    assert len({path, other_cpu, native.library_path()}) == 3


def test_loader_raises_without_a_compiler(tmp_path):
    """A fresh build directory and a PATH without g++: `load` must raise
    `NativeBuildError`, not report the library as unavailable."""
    empty = tmp_path / "bin"
    empty.mkdir()
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from iggt_official_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path / 'build')!r})\n"
        "try:\n"
        "    native.load()\n"
        "except native.NativeBuildError as exc:\n"
        "    print(exc)\n"
        "    sys.exit(3)\n"
        "sys.exit(0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PATH=str(empty)))
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "g++ not found" in proc.stdout


def test_library_loads_and_answers():
    lib_path, _ = native.build()
    assert lib_path.exists()
    dist, idx = native.knn_query([[0.0, 0.0], [1.0, 0.0], [3.0, 0.0]], 2)
    assert idx.tolist() == [[0, 1], [1, 0], [2, 1]]
    assert dist[:, 1].tolist() == [1.0, 1.0, 2.0]
