"""Host routers (port of `akka_tpu/routing/router.py` and
`routed_cell.py`): pools, groups and the routed actor cell."""
