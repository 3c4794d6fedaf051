"""Miner node (L3'): event loop, job queue, solver pipeline, stake
manager, for the port. Mirrors arbius_tpu/node's exports apart from the
other families' runners, which wait for a later slice."""
from arbius_tpu_torch.node.chain_client import LocalChain
from arbius_tpu_torch.node.config import (
    AutomineConfig,
    ConfigError,
    DeploymentConfig,
    MiningConfig,
    ModelConfig,
    PipelineConfig,
    SchedConfig,
    StakeConfig,
    load_config,
    load_deployment,
)
from arbius_tpu_torch.node.db import Job, NodeDB
from arbius_tpu_torch.node.factory import build_anythingv3, build_registry
from arbius_tpu_torch.node.node import BootError, MinerNode, NodeMetrics
from arbius_tpu_torch.node.pinners import (
    HttpDaemonPinner,
    LocalPinner,
    PinMismatchError,
)
from arbius_tpu_torch.node.retry import RetriesExhausted, expretry
from arbius_tpu_torch.node.rpc_chain import ChainRpcError, RpcChain
from arbius_tpu_torch.node.solver import (
    ModelRegistry,
    RegisteredModel,
    SD15Runner,
    chunk_items,
    solve_cid,
    solve_cid_batch,
    solve_files,
    solve_files_batch,
)
from arbius_tpu_torch.node.store import ContentStore, cid_b58
from arbius_tpu_torch.obs import Obs

__all__ = [
    "AutomineConfig", "BootError", "ChainRpcError", "ConfigError",
    "ContentStore",
    "DeploymentConfig", "HttpDaemonPinner", "Job", "LocalChain",
    "LocalPinner", "MinerNode", "MiningConfig", "ModelConfig",
    "ModelRegistry", "NodeDB", "NodeMetrics", "Obs", "PinMismatchError",
    "PipelineConfig", "RegisteredModel", "RetriesExhausted", "RpcChain",
    "SD15Runner",
    "SchedConfig", "StakeConfig", "build_anythingv3", "build_registry",
    "chunk_items", "cid_b58", "expretry", "load_config", "load_deployment",
    "solve_cid", "solve_cid_batch", "solve_files", "solve_files_batch",
]
