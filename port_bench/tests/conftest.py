"""The checkout's root on the path, so the tests import ``port_bench``
and the port as a run does."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
