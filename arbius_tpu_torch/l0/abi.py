"""Minimal Solidity ABI encoder/decoder — just the types the protocol uses.

The reference computes ids/commitments with ethers' defaultAbiCoder
(`miner/src/utils.ts:42-49`) matching on-chain abi.encode
(`contract/contracts/EngineV1.sol:431-438` hashTask, :418-425 hashModel,
:537-543 generateCommitment). Supported types: address, bytes32, uintN,
bool, bytes, string. All values encode per the standard head/tail layout;
`abi_decode` inverts it for eth_call results and calldata parsing.
"""
from __future__ import annotations


def _pad32(b: bytes, left: bool = True) -> bytes:
    if len(b) > 32:
        raise ValueError("value longer than 32 bytes")
    pad = b"\x00" * (32 - len(b))
    return pad + b if left else b + pad


def _enc_static(typ: str, value) -> bytes:
    if typ in ("address", "bytes32"):
        if isinstance(value, str):
            v = bytes.fromhex(value[2:] if value.startswith("0x") else value)
        elif isinstance(value, (bytes, bytearray)):
            v = bytes(value)
        else:
            # bytes(int) would silently yield N zero bytes — make it loud
            raise ValueError(f"{typ} value must be hex string or bytes, got {type(value).__name__}")
        want = 20 if typ == "address" else 32
        if len(v) != want:
            raise ValueError(f"{typ} must be {want} bytes")
        return _pad32(v) if typ == "address" else v
    if typ in ("uint256", "uint64", "uint32", "uint8", "uint"):
        v = int(value)
        bits = 256 if typ == "uint" else int(typ[4:])
        if not 0 <= v < (1 << bits):
            raise ValueError(f"value {v} out of range for {typ}")
        return v.to_bytes(32, "big")
    if typ == "bool":
        return int(bool(value)).to_bytes(32, "big")
    raise ValueError(f"unsupported static type {typ}")


def _enc_dynamic(typ: str, value) -> bytes:
    # Dispatch on the DECLARED type, matching ethers defaultAbiCoder:
    # "string" is always utf-8 text (even if it looks like hex);
    # "bytes" takes raw bytes or a 0x-hex string, nothing else.
    if typ == "string":
        if not isinstance(value, str):
            raise ValueError("string value must be str")
        v = value.encode("utf-8")
    else:  # bytes
        if isinstance(value, str):
            if not value.startswith("0x"):
                raise ValueError("bytes value must be raw bytes or 0x-hex string")
            v = bytes.fromhex(value[2:])
        else:
            v = bytes(value)
    padded_len = (len(v) + 31) // 32 * 32
    return int(len(v)).to_bytes(32, "big") + v + b"\x00" * (padded_len - len(v))


_DYNAMIC = ("bytes", "string")


def abi_encode(types: list[str], values: list) -> bytes:
    """abi.encode(...) — standard (non-packed) encoding."""
    if len(types) != len(values):
        raise ValueError("types/values length mismatch")
    head = []
    tail = []
    head_size = 32 * len(types)
    for typ, val in zip(types, values):
        if typ in _DYNAMIC:
            head.append(None)  # patched below
            tail.append(_enc_dynamic(typ, val))
        else:
            head.append(_enc_static(typ, val))
            tail.append(b"")
    out_head = []
    offset = head_size
    for h, t in zip(head, tail):
        if h is None:
            out_head.append(int(offset).to_bytes(32, "big"))
            offset += len(t)
        else:
            out_head.append(h)
    return b"".join(out_head) + b"".join(tail)


def _dec_static(typ: str, word: bytes):
    if typ == "address":
        return "0x" + word[12:].hex()
    if typ == "bytes32":
        return word
    if typ in ("uint256", "uint64", "uint32", "uint8", "uint"):
        return int.from_bytes(word, "big")
    if typ == "bool":
        return bool(int.from_bytes(word, "big"))
    raise ValueError(f"unsupported static type {typ}")


def abi_decode(types: list[str], data: bytes) -> list:
    """Inverse of abi_encode over the same type subset.

    Dynamic values (`bytes`, `string`) are resolved through their head
    offsets; offsets and lengths are bounds-checked so malformed payloads
    raise instead of silently truncating.
    """
    if len(data) < 32 * len(types):
        raise ValueError("abi data shorter than head")
    out = []
    for i, typ in enumerate(types):
        word = data[32 * i:32 * i + 32]
        if typ in _DYNAMIC:
            off = int.from_bytes(word, "big")
            if off + 32 > len(data):
                raise ValueError("dynamic offset out of range")
            n = int.from_bytes(data[off:off + 32], "big")
            if off + 32 + n > len(data):
                raise ValueError("dynamic length out of range")
            v = data[off + 32:off + 32 + n]
            out.append(v.decode("utf-8") if typ == "string" else v)
        else:
            out.append(_dec_static(typ, word))
    return out
