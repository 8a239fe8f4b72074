"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the checkout (``-m cuda`` on a machine with the card). They
import the benchmark as the package ``benchmark`` from the checkout."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
