"""Commitment hash + deterministic seed derivation (L0).

Parity targets: `miner/src/utils.ts:42-49` (generateCommitment must equal
on-chain `EngineV1.sol:537-543`), `miner/src/utils.ts:15-19` (taskid2Seed).
"""
from __future__ import annotations

from arbius_tpu_torch.l0.abi import abi_encode
from arbius_tpu_torch.l0.keccak import keccak256

# miner/src/utils.ts:17 — Number.MAX_SAFE_INTEGER - 15, keeps seeds in the
# range all samplers/tooling accept.
SEED_MODULUS = 0x1FFFFFFFFFFFF0


def taskid2seed(taskid: str | bytes | int) -> int:
    """Deterministic per-task RNG seed: uint(taskid) mod 0x1FFFFFFFFFFFF0."""
    if isinstance(taskid, bytes):
        value = int.from_bytes(taskid, "big")
    elif isinstance(taskid, int):
        value = taskid
    else:
        value = int(taskid, 16)
    return value % SEED_MODULUS


def generate_commitment(address: str, taskid: str | bytes, cid: str | bytes) -> bytes:
    """keccak256(abi.encode(address, bytes32 taskid, bytes cid))."""
    return keccak256(abi_encode(["address", "bytes32", "bytes"], [address, taskid, cid]))


def generate_commitment_hex(address: str, taskid: str | bytes, cid: str | bytes) -> str:
    return "0x" + generate_commitment(address, taskid, cid).hex()
