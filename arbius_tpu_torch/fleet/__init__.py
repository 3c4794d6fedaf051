"""arbius_tpu_torch.fleet — multi-process fleet mining (docs/fleet.md).

From one node to a swarm: a `FleetCoordinator` owns the chain event
stream and deals tasks across N worker processes through a shared
sqlite lease table (`LeaseTable`: WAL + busy_timeout file locking,
work-stealing `acquire` with heartbeat TTLs, cross-process commit
dedupe, shared-wallet nonce guard). Workers are full `MinerNode`s in
worker mode — `LeaseFeed.attach(node)` rewires task intake and the
commit step; everything downstream is the single-node solve path, so a
fleet of one is byte-identical to a bare miner.

There is no RPC between fleet members: the lease database IS the
coordination plane, which is what makes the fleet genuinely
multi-process (any member can die and restart without a handshake).
`python -m arbius_tpu_torch.fleet --role coordinator|worker` runs one member
per process; the simnet fleet harness (arbius_tpu/sim/fleet.py) drives
the same objects deterministically under SIM111.
"""
from arbius_tpu_torch.fleet.coordinator import FleetCoordinator
from arbius_tpu_torch.fleet.lease import (
    LEASE_STATES,
    TERMINAL_STATES,
    LeaseGrant,
    LeaseTable,
    connect_fleet_db,
)
from arbius_tpu_torch.fleet.worker import LeaseFeed, make_worker_id

__all__ = [
    "FleetCoordinator", "LEASE_STATES", "LeaseFeed", "LeaseGrant",
    "LeaseTable", "TERMINAL_STATES", "connect_fleet_db",
    "make_worker_id",
]
