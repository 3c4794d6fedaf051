"""IPFS CIDv0 computation — the deterministic artifact kernel (L0).

Three byte-compatible implementations exist in the reference and must agree:
on-chain Solidity (`contract/contracts/libraries/IPFS.sol:38-67`), the IPFS
daemon the miner pins through (`miner/src/ipfs.ts:11-16` — cidVersion 0,
sha2-256, chunker size-262144, rawLeaves false, wrapWithDirectory true), and
the website's base58<->hex converter. This module implements all of it
standalone, so the node never needs an IPFS daemon to know a CID before
pinning.

Layout notes (dag-pb / UnixFS):
  PBNode      { Links: repeated field 2 (PBLink), Data: field 1 (bytes) }
              — canonical dag-pb serialization writes Links BEFORE Data.
  PBLink      { Hash: field 1 (bytes), Name: field 2 (string, always
              emitted, may be empty), Tsize: field 3 (varint) }
  UnixFS Data { Type: field 1 varint (1=Directory, 2=File),
              Data: field 2 (bytes, omitted when empty),
              filesize: field 3 varint,
              blocksizes: repeated field 4 varint }

A CIDv0 is the 34-byte multihash 0x1220 || sha256(block).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from arbius_tpu_torch.l0.varint import encode_varint
from arbius_tpu_torch.l0.base58 import b58encode

CHUNK_SIZE = 262144            # miner/src/ipfs.ts:14 "size-262144"
MAX_LINKS_PER_BLOCK = 174      # go-ipfs balanced DAG builder default width
ONCHAIN_MAX_CONTENT = 65536    # libraries/IPFS.sol:39


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def cidv0(block: bytes) -> bytes:
    """34-byte multihash (0x1220 prefix) of a serialized dag-pb block."""
    return b"\x12\x20" + sha256(block)


def _lenprefixed(field_tag: bytes, payload: bytes) -> bytes:
    return field_tag + encode_varint(len(payload)) + payload


def unixfs_file_leaf(content: bytes) -> bytes:
    """Serialized PBNode for a single UnixFS file chunk (rawLeaves=false).

    Matches the on-chain encoder byte-for-byte for non-empty content
    (`libraries/IPFS.sol:42-64`): Data = 0802 | 12 <len> content | 18 <len>,
    wrapped in PBNode field 1.
    """
    unixfs = b"\x08\x02"
    if content:
        unixfs += _lenprefixed(b"\x12", content)
    unixfs += b"\x18" + encode_varint(len(content))
    return _lenprefixed(b"\x0a", unixfs)


def cid_onchain(content: bytes) -> bytes:
    """Exact mirror of Solidity getIPFSCID (`libraries/IPFS.sol:38-67`).

    Note the contract always emits the UnixFS Data field, even when content
    is empty — go-ipfs omits it for empty files. Mirror the contract here,
    including its 65536-byte cap.
    """
    if len(content) > ONCHAIN_MAX_CONTENT:
        raise ValueError("Max content size is 65536 bytes")
    lv = encode_varint(len(content))
    meat = b"\x08\x02\x12" + lv + content + b"\x18" + lv
    return cidv0(b"\x0a" + encode_varint(len(meat)) + meat)


@dataclass(frozen=True)
class DagNode:
    """A computed dag-pb node: its CID and the sizes needed by parents."""
    cid: bytes          # 34-byte multihash
    block_size: int     # serialized block length
    tsize: int          # cumulative dag size (block + all descendants)
    content_size: int   # UnixFS file/dir logical content bytes


def _pblink(child: DagNode, name: str) -> bytes:
    link = _lenprefixed(b"\x0a", child.cid)
    link += _lenprefixed(b"\x12", name.encode("utf-8"))
    link += b"\x18" + encode_varint(child.tsize)
    return _lenprefixed(b"\x12", link)


def _file_parent(children: list[DagNode]) -> DagNode:
    """Internal balanced-DAG node over file chunks/subtrees."""
    filesize = sum(c.content_size for c in children)
    links = b"".join(_pblink(c, "") for c in children)
    unixfs = b"\x08\x02" + b"\x18" + encode_varint(filesize)
    unixfs += b"".join(b"\x20" + encode_varint(c.content_size) for c in children)
    block = links + _lenprefixed(b"\x0a", unixfs)
    tsize = len(block) + sum(c.tsize for c in children)
    return DagNode(cidv0(block), len(block), tsize, filesize)


def dag_of_file(content: bytes) -> DagNode:
    """Balanced UnixFS DAG for arbitrary-size content (daemon settings).

    size-262144 chunker, rawLeaves=false, width-174 balanced layout — the
    exact profile in `miner/src/ipfs.ts:11-16`, so CIDs match what the
    reference miner's daemon would return for the same bytes.
    """
    chunks = [content[i:i + CHUNK_SIZE] for i in range(0, len(content), CHUNK_SIZE)]
    if not chunks:
        chunks = [b""]
    level: list[DagNode] = []
    for ch in chunks:
        block = unixfs_file_leaf(ch)
        level.append(DagNode(cidv0(block), len(block), len(block), len(ch)))
    if len(level) == 1:
        return level[0]
    while len(level) > 1:
        level = [
            _file_parent(level[i:i + MAX_LINKS_PER_BLOCK])
            for i in range(0, len(level), MAX_LINKS_PER_BLOCK)
        ]
    return level[0]


HAMT_FANOUT = 256              # kubo DefaultShardWidth
HAMT_HASH_MURMUR3 = 0x22       # multihash code for murmur3-x64-64


def _hamt_shard(items: list[tuple[str, DagNode]], depth: int,
                sink=None) -> DagNode:
    """One HAMT shard node (UnixFS Type=5) over (name, child) entries.

    go-unixfs layout: slot index at depth d = byte d of the murmur3-64
    name hash; an occupied slot holds either the entry itself (link named
    '%02X' + name) or a child shard ('%02X' alone) when names collide at
    this depth. The Data field is the occupancy bitfield as a minimal
    big-endian integer; hashType/fanout ride UnixFS fields 5/6."""
    from arbius_tpu_torch.l0.murmur3 import hamt_hash

    if depth >= 8:
        # 8 hash bytes consumed — 256^8 slots; unreachable without a
        # deliberate collision attack on murmur3
        raise ValueError("HAMT depth exhausted (hash collision)")
    slots: dict[int, list[tuple[str, DagNode]]] = {}
    for name, node in items:
        slots.setdefault(hamt_hash(name)[depth], []).append((name, node))
    links = b""
    bitfield = 0
    tsize_children = 0
    for idx in sorted(slots):
        bitfield |= 1 << idx
        bucket = slots[idx]
        if len(bucket) == 1:
            name, node = bucket[0]
            links += _pblink(node, f"{idx:02X}{name}")
        else:
            node = _hamt_shard(bucket, depth + 1, sink)
            links += _pblink(node, f"{idx:02X}")
        tsize_children += node.tsize
    bf_bytes = bitfield.to_bytes((bitfield.bit_length() + 7) // 8, "big")
    unixfs = b"\x08\x05"                      # Type = HAMTShard
    unixfs += _lenprefixed(b"\x12", bf_bytes)  # Data = bitfield
    unixfs += b"\x28" + encode_varint(HAMT_HASH_MURMUR3)  # hashType
    unixfs += b"\x30" + encode_varint(HAMT_FANOUT)        # fanout
    block = links + _lenprefixed(b"\x0a", unixfs)
    node = DagNode(cidv0(block), len(block), len(block) + tsize_children,
                   sum(n.content_size for _, n in items))
    if sink is not None:
        sink(node.cid, block)
    return node


def dag_of_directory(entries: dict[str, bytes], sink=None) -> DagNode:
    """UnixFS directory over named files, links sorted by name (go-ipfs).

    This is the wrapWithDirectory=true root the miner submits as the
    solution CID (`miner/src/ipfs.ts:42-47` extracts the wrapping root).
    Directories whose flat block would exceed 256 KiB are HAMT-sharded
    exactly as kubo auto-shards them (HAMTShardingSize), so huge output
    sets still produce daemon-parity CIDs. `sink(cid, block)`, when
    given, receives every directory-level block (for content stores)."""
    for name in entries:
        if "/" in name:
            # the daemon would treat this as a nested path, not a flat name
            raise ValueError(f"directory entry name may not contain '/': {name!r}")
    children = {name: dag_of_file(data) for name, data in entries.items()}
    # kubo's auto-shard trigger is its ESTIMATED directory size — per
    # entry len(name) + len(cid bytes), no protobuf framing or Tsize
    # varints (go-unixfs io.BasicDirectory estimatedSize vs
    # HAMTShardingSize = 256 KiB) — not the serialized block length.
    # Matching the estimate matters near the boundary: a directory the
    # daemon keeps flat must stay flat here or the solution CID diverges.
    estimate = sum(len(name.encode("utf-8")) + len(node.cid)
                   for name, node in children.items())
    if estimate > CHUNK_SIZE:
        return _hamt_shard(sorted(children.items()), 0, sink)
    links = b"".join(_pblink(children[name], name) for name in sorted(children))
    unixfs = b"\x08\x01"
    block = links + _lenprefixed(b"\x0a", unixfs)
    tsize = len(block) + sum(c.tsize for c in children.values())
    dirsize = sum(c.content_size for c in children.values())
    node = DagNode(cidv0(block), len(block), tsize, dirsize)
    if sink is not None:
        sink(node.cid, block)
    return node


def cid_of_solution_files(files: dict[str, bytes]) -> bytes:
    """Solution CID for a set of output files: dir-wrapped root multihash.

    Equivalent to the reference path pinFilesToIPFS -> base58 -> hex
    (`miner/src/ipfs.ts:28-76`, `miner/src/models.ts:34-54`) but computed
    locally and deterministically.
    """
    return dag_of_directory(files).cid


def cid_hex(cid: bytes) -> str:
    return "0x" + cid.hex()


def cid_base58(cid: bytes) -> str:
    return b58encode(cid)
