"""Content store — solution data availability (L2' storage half).

The reference pins outputs to IPFS via a local daemon or Pinata and the
task owner fetches them by CID (`miner/src/ipfs.ts:28-76`, `:79-114`).
This framework computes CIDs locally (l0/cid.py); the store is the other
half: it PERSISTS the bytes under their CID and serves them back, so a
committed solution is actually retrievable — a solution whose bytes
nobody can fetch is economically worthless and trivially contestable.

Layout (content-addressed, atomic writes):

    <root>/files/<file_cid_b58>        raw file bytes
    <root>/dirs/<root_cid_b58>.json    {"name": "<file_cid_b58>", ...}

Invariant: `put_files` recomputes the dir-wrapped root CID from the
bytes it stores, so stored-bytes CID == `cid_of_solution_files` == the
CID the node committed on-chain (asserted in tests).
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from arbius_tpu_torch.l0.base58 import b58decode, b58encode
from arbius_tpu_torch.l0.cid import cid_of_solution_files, dag_of_file


def cid_b58(cid: bytes | str) -> str:
    """Normalize a CID given as multihash bytes, 0x-hex, or base58."""
    if isinstance(cid, bytes):
        raw = cid
    elif cid.startswith("0x"):
        raw = bytes.fromhex(cid[2:])
    else:
        raw = b58decode(cid)
    if len(raw) != 34 or raw[:2] != b"\x12\x20":
        raise ValueError(f"not a CIDv0 sha2-256 multihash: {cid!r}")
    return b58encode(raw)


class ContentStore:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        (self.root / "files").mkdir(parents=True, exist_ok=True)
        (self.root / "dirs").mkdir(parents=True, exist_ok=True)

    # -- write -----------------------------------------------------------
    def _write_atomic(self, path: Path, data: bytes) -> None:
        if path.exists():
            return  # content-addressed: same name == same bytes
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def put_blob(self, data: bytes) -> bytes:
        """Store one file's bytes; returns its (file-level) CID."""
        cid = dag_of_file(data).cid
        self._write_atomic(self.root / "files" / b58encode(cid), data)
        return cid

    def put_files(self, files: dict[str, bytes]) -> bytes:
        """Store a solution's files + dir manifest; returns the root CID
        (the multihash the node commits on-chain)."""
        manifest = {}
        for name, data in files.items():
            manifest[name] = b58encode(self.put_blob(data))
        root = cid_of_solution_files(files)
        self._write_atomic(self.root / "dirs" / (b58encode(root) + ".json"),
                           json.dumps(manifest, sort_keys=True).encode())
        return root

    # -- read ------------------------------------------------------------
    def has(self, cid: bytes | str) -> bool:
        b58 = cid_b58(cid)
        return (self.root / "files" / b58).exists() or \
            (self.root / "dirs" / (b58 + ".json")).exists()

    def get_file(self, cid: bytes | str) -> bytes | None:
        path = self.root / "files" / cid_b58(cid)
        return path.read_bytes() if path.exists() else None

    def get_dir(self, root_cid: bytes | str) -> dict[str, str] | None:
        """Manifest of a stored solution: {filename: file_cid_b58}."""
        path = self.root / "dirs" / (cid_b58(root_cid) + ".json")
        return json.loads(path.read_text()) if path.exists() else None

    def resolve(self, root_cid: bytes | str, name: str) -> bytes | None:
        """`<root>/<name>` path resolution, gateway-style."""
        manifest = self.get_dir(root_cid)
        if manifest is None or name not in manifest:
            return None
        return self.get_file(manifest[name])

    def stats(self) -> dict:
        # detlint: allow[DET103] len/sum aggregates are order-independent
        files = list((self.root / "files").iterdir())
        return {"files": len(files),
                # detlint: allow[DET103] order-independent count
                "dirs": len(list((self.root / "dirs").iterdir())),
                "bytes": sum(f.stat().st_size for f in files)}
