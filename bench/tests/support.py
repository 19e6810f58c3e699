"""What the benchmark's tests share: the repository's root, and a copy of
the benchmark (``BENCHMARK.json`` and ``bench/``) to change in a test."""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _path in (str(ROOT / "src"), str(ROOT)):
    if _path not in sys.path:
        sys.path.insert(0, _path)

#: the CPU sizes of each configuration (widths too: a test's size)
TINY = {
    "dit-xl-2-256": dict(depth=2, hidden_size=64, num_heads=4, input_size=8),
    "mamba2-1.3b-denoiser": dict(n_layer=2, d_model=64, headdim=16,
                                 d_state=16, chunk_size=32, tokens=64,
                                 vocab_size=100),
}


def copy_bench(dest: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


def shrink(root: Path) -> Path:
    """Cuts the copy's configurations to :data:`TINY` by their files."""
    for name, sizes in TINY.items():
        path = root / "bench" / "configs" / f"{name}.json"
        conf = json.loads(path.read_text())
        conf.update(sizes)
        path.write_text(json.dumps(conf))
    return root
