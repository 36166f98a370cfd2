"""Membership settings for clusters of nodes in one process (a port
addition, no file of the reference): the reference's cluster tests'
fast timing (tests/test_cluster.py:117-131), in one place for the port's
loopback cluster tests and `chip_smoke.py`'s cluster_router.

    {"akka": {"cluster": FAST_MEMBERSHIP, ...}}

Gossip and leader actions every 0.05 s, heartbeats every 0.1 s with a
2 s acceptable pause (a loaded host must not suspect a live node), and
keep-majority downing once the unreachable set is stable for 1 s.
"""

FAST_MEMBERSHIP = {"gossip-interval": "0.05s",
                   "leader-actions-interval": "0.05s",
                   "unreachable-nodes-reaper-interval": "0.1s",
                   "failure-detector": {"heartbeat-interval": "0.1s",
                                        "acceptable-heartbeat-pause": "2s"},
                   "split-brain-resolver": {
                       "active-strategy": "keep-majority",
                       "stable-after": "1s"}}
