"""L0 — deterministic primitives: CIDv0/UnixFS hashing, keccak
commitments, ABI encoding, base58, seed derivation. Copies of the
reference's `arbius_tpu/l0` (keccak on its pure-Python path)."""
from arbius_tpu_torch.l0.cid import (
    cid_hex,
    cid_of_solution_files,
    cid_onchain,
)
from arbius_tpu_torch.l0.commitment import (
    generate_commitment,
    generate_commitment_hex,
    taskid2seed,
)

__all__ = [
    "cid_hex",
    "cid_of_solution_files",
    "cid_onchain",
    "generate_commitment",
    "generate_commitment_hex",
    "taskid2seed",
]
