"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks
for. Prints the numbers compared against the plain reference, each beside
its limit, as the last lines of standard error, and one JSON result as
the last line of standard output (harness.py says what is in it). Exits
3 without a result when the cards are missing, and 4 when a JAX module
was loaded.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root in place of this script's folder, whose subfolders
# (metrics/, tests/, ...) would shadow top-level modules of those names
sys.path[0] = str(ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    t_start = harness.process_start()
    sys.exit(harness.main(sys.argv[1:], t_start))
