"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the repository. They import the benchmark as the package
`benchmark`, from the root."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
