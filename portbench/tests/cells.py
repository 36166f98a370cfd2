"""The benchmark's cells at sizes a CPU test holds: the configurations and
mixes of BENCHMARK.json with their scale cut (shards, rows, callers,
callers), everything else as committed."""

from portbench import harness

# (the promise block is one block of rows: it holds the 4 x 16 asks in
# flight)
SMALL_CONFIG = {"sharded-counter-4m": {"number_of_shards": 2,
                                       "entities_per_shard": 64,
                                       "recordcount": 128},
                "savina-thread-ring": {}}
SMALL_TRAFFIC = {"region": {"callers": 4, "call_size": 16}, "ring": {}}
CELLS = ("counter-zipf", "counter-uniform", "ring-one")


def small_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, **SMALL_CONFIG[cell.config["name"]])
    cell.traffic = dict(cell.traffic,
                        **SMALL_TRAFFIC[cell.config["system"]])
    return cell


def run_small(name: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
              control: bool = False, trace: bool = False
              ) -> harness.RunOutcome:
    import time
    return harness.run_cell(small_cell(name), seed, seconds, trace,
                            time.perf_counter(), device="cpu",
                            control=control)
