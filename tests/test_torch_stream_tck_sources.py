"""The port's publisher battery (akka_tpu_torch.stream.tck) on the
publishers of tests/test_stream_tck.py built from a source alone, and on
the restarting source of tests/test_stream_supervision.py, side by side
with the JAX package's. The tables and the checks are those of
tests/test_torch_stream_tck.py; the cases run here so that each file stays
well inside its time (the battery waits out about 1 s of silence a
package).
"""

import pytest

from torch_stream_fixture import side_by_side
from test_torch_stream_tck import SOURCE_PUBLISHERS, _tck, check_publisher


@pytest.mark.parametrize("name", sorted(SOURCE_PUBLISHERS))
def test_publisher_compliance(name):
    check_publisher(name)


@side_by_side
def test_restart_source_passes_publisher_tck(S):
    fast = S.RestartSettings(min_backoff=0.02, max_backoff=0.1,
                             random_factor=0.0)
    return _tck(S).verify_publisher(
        lambda n: S.RestartSource.on_failures_with_backoff(
            fast, lambda: S.Source.from_iterable(range(n))), S.system)
