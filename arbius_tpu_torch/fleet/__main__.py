"""Fleet launcher — one fleet member per process (docs/fleet.md).

    # coordinator (owns the event stream, feeds the lease table)
    python -m arbius_tpu_torch.fleet --role coordinator \
        --config MiningConfig.json --deployment Deployment.json

    # workers (one process each; scale horizontally)
    python -m arbius_tpu_torch.fleet --role worker --worker-id 0 \
        --config MiningConfig.json --deployment Deployment.json

Every member opens the same `fleet.lease_db` file — the only shared
state. Per-worker wallets come from ARBIUS_WALLET_KEY in each worker's
environment (never from the config file); in `wallet_mode: "shared"`
all workers read the same key and tx signing serializes through the
lease table's wallet guard.

The simnet fleet harness (arbius_tpu/sim/fleet.py) drives these same
objects deterministically — this launcher only does the production
wiring: config → chain facade → coordinator/worker loop.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_chain(deployment, key_hex: str, *, tx_guard=None):
    """DeploymentConfig + wallet key → RpcChain over a live endpoint."""
    from arbius_tpu_torch.chain.rpc_client import (
        EngineRpcClient,
        JsonRpcTransport,
    )
    from arbius_tpu_torch.chain.wallet import Wallet
    from arbius_tpu_torch.node.rpc_chain import RpcChain

    client = EngineRpcClient(
        JsonRpcTransport(deployment.rpc_url),
        deployment.engine_address, Wallet.from_hex(key_hex),
        chain_id=deployment.chain_id, tx_guard=tx_guard)
    return RpcChain(client, deployment.token_address,
                    start_block=deployment.start_block)


def _make_sidecar(cfg, member: str, obs):
    """fleetscope sidecar for this member when `fleet.sidecar_dir` is
    configured (docs/fleetscope.md); None = fleetscope off."""
    if not cfg.fleet.sidecar_dir:
        return None
    from arbius_tpu_torch.obs.fleetscope import ObsSidecar, sidecar_path

    os.makedirs(cfg.fleet.sidecar_dir, exist_ok=True)
    return ObsSidecar(sidecar_path(cfg.fleet.sidecar_dir, member),
                      member, obs)


def run_coordinator(cfg, deployment, key_hex: str, *, stop=None,
                    metrics_port: int | None = None) -> None:
    from arbius_tpu_torch.fleet import FleetCoordinator, LeaseTable

    leases = LeaseTable(cfg.fleet.lease_db, cfg.fleet.busy_timeout_ms)
    chain = build_chain(deployment, key_hex)
    coord = FleetCoordinator(chain, leases,
                             [m.id for m in cfg.models if m.enabled],
                             cfg.fleet)
    coord.sidecar = _make_sidecar(cfg, "coordinator", coord.obs)
    server = None
    if metrics_port is not None:
        # the federated scrape (docs/fleetscope.md): one GET /metrics
        # for the whole fleet, merged from the sidecars + the
        # coordinator's own live registry
        if not cfg.fleet.sidecar_dir:
            raise SystemExit("--metrics-port needs fleet.sidecar_dir "
                             "(the federated view merges the sidecars)")
        from arbius_tpu_torch.obs.fleetscope import FleetMetricsServer

        server = FleetMetricsServer(cfg.fleet.sidecar_dir, coord.obs,
                                    port=metrics_port)
        server.start()
    try:
        coord.run(stop=stop)
    finally:
        if server is not None:
            server.stop()
        if coord.sidecar is not None:
            coord.sidecar.flush(coord.chain.now)
            coord.sidecar.close()
        leases.close()


def run_worker(cfg, deployment, key_hex: str, worker_index: int, *,
               stop=None) -> None:
    from arbius_tpu_torch.fleet import LeaseFeed, LeaseTable, make_worker_id
    from arbius_tpu_torch.node import MinerNode, NodeDB
    from arbius_tpu_torch.node.factory import build_registry

    worker_id = make_worker_id(worker_index)
    leases = LeaseTable(cfg.fleet.lease_db, cfg.fleet.busy_timeout_ms)
    tx_guard = None
    chain = build_chain(deployment, key_hex)
    if cfg.fleet.wallet_mode == "shared":
        address = chain.address
        tx_guard = lambda: leases.wallet_guard(address, worker_id)  # noqa: E731
        chain.client.tx_guard = tx_guard
    registry = build_registry(cfg)
    db = NodeDB(f"{cfg.db_path}.{worker_id}"
                if cfg.db_path != ":memory:" else ":memory:",
                busy_timeout_ms=cfg.db_busy_timeout_ms)
    node = MinerNode(chain, cfg, registry, db=db)
    feed = LeaseFeed(leases, worker_id, cfg.fleet).attach(node)
    sidecar = _make_sidecar(cfg, worker_id, node.obs)
    if sidecar is not None:
        feed.attach_sidecar(sidecar, every=cfg.fleet.sidecar_flush_every)
    try:
        node.boot()
        node.run(stop=stop)
    finally:
        if sidecar is not None:
            feed.flush_sidecar(node.chain.now)
            sidecar.close()
        node.close()
        leases.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m arbius_tpu_torch.fleet", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--role", required=True,
                   choices=("coordinator", "worker"))
    p.add_argument("--config", required=True,
                   help="MiningConfig JSON (fleet block required)")
    p.add_argument("--deployment", required=True,
                   help="DeploymentConfig JSON (chain endpoint)")
    p.add_argument("--worker-id", type=int, default=0,
                   help="worker index (role=worker; unique per process)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="role=coordinator: serve the federated fleet "
                        "GET /metrics on this port (needs "
                        "fleet.sidecar_dir — docs/fleetscope.md)")
    ns = p.parse_args(argv)

    from arbius_tpu_torch.node.config import (
        ConfigError,
        load_config,
        load_deployment,
    )

    try:
        with open(ns.config, encoding="utf-8") as fh:
            cfg = load_config(fh.read())
        with open(ns.deployment, encoding="utf-8") as fh:
            deployment = load_deployment(fh.read())
    except (OSError, ValueError, ConfigError) as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 2
    if not cfg.fleet.enabled:
        print("fleet.enabled is false in the config — refusing to start "
              "a fleet member against a single-node config",
              file=sys.stderr)
        return 2
    key = os.environ.get("ARBIUS_WALLET_KEY", "")
    if not key:
        print("ARBIUS_WALLET_KEY is not set (hex private key; "
              "per-worker wallets each export their own)",
              file=sys.stderr)
        return 2
    if ns.role == "coordinator":
        run_coordinator(cfg, deployment, key,
                        metrics_port=ns.metrics_port)
    else:
        run_worker(cfg, deployment, key, ns.worker_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
