"""Compact DER (ASN.1) parser and encoder, host side.

The port's own copy of ``passport_zk_circuits_tpu/ingest/asn1.py`` (the
same code; ``tests/test_torch_copies.py`` holds its syntax tree equal to
the original's, imports and docstrings aside). It plays the role of the
reference's vendored asn1js parser (``test/asn1.js``
Stream/ASN1/simplifyASN1): enough DER to walk an eMRTD SOD (SignedData),
extract the encapsulated content, signed attributes, signature and signer
public key, and to build synthetic SODs for tests.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

# universal tags
SEQUENCE = 0x30
SET = 0x31
INTEGER = 0x02
BIT_STRING = 0x03
OCTET_STRING = 0x04
NULL = 0x05
OID = 0x06
UTF8STRING = 0x0C
PRINTABLE = 0x13


@dataclasses.dataclass
class Node:
    tag: int
    content: bytes              # raw content octets
    children: List["Node"]
    offset: int                 # offset of the full TLV in the buffer
    header_len: int

    @property
    def constructed(self) -> bool:
        return bool(self.tag & 0x20)

    @property
    def raw(self) -> bytes:
        """Re-encoded full TLV (DER is canonical, so this is bit-exact)."""
        return tlv(self.tag, self.content)

    def child(self, i: int) -> "Node":
        return self.children[i]

    def find(self, tag: int) -> Optional["Node"]:
        for c in self.children:
            if c.tag == tag:
                return c
        return None

    def as_int(self) -> int:
        return int.from_bytes(self.content, "big", signed=False)

    def as_oid(self) -> str:
        data = self.content
        first = data[0]
        parts = [first // 40, first % 40]
        v = 0
        for b in data[1:]:
            v = (v << 7) | (b & 0x7F)
            if not b & 0x80:
                parts.append(v)
                v = 0
        return ".".join(str(p) for p in parts)


def parse(data: bytes, offset: int = 0) -> Node:
    """Parse one DER TLV at `offset` (recursively for constructed types)."""
    tag = data[offset]
    i = offset + 1
    first = data[i]
    i += 1
    if first < 0x80:
        length = first
    else:
        n = first & 0x7F
        length = int.from_bytes(data[i:i + n], "big")
        i += n
    header_len = i - offset
    content = data[i:i + length]
    children = []
    if tag & 0x20:  # constructed
        pos = i
        end = i + length
        while pos < end:
            child = parse(data, pos)
            children.append(child)
            pos += child.header_len + len(child.content)
    return Node(tag, content, children, offset, header_len)


def parse_all(data: bytes) -> List[Node]:
    nodes, pos = [], 0
    while pos < len(data):
        n = parse(data, pos)
        nodes.append(n)
        pos += n.header_len + len(n.content)
    return nodes


# ---------------------------------------------------------------------------
# DER encoding (for synthetic SOD construction)
# ---------------------------------------------------------------------------

def encode_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def tlv(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + encode_len(len(content)) + content


def seq(*parts: bytes) -> bytes:
    return tlv(SEQUENCE, b"".join(parts))


def der_set(*parts: bytes) -> bytes:
    return tlv(SET, b"".join(parts))


def integer(v: int) -> bytes:
    if v == 0:
        return tlv(INTEGER, b"\x00")
    body = v.to_bytes((v.bit_length() + 7) // 8, "big")
    if body[0] & 0x80:
        body = b"\x00" + body
    return tlv(INTEGER, body)


def oid(dotted: str) -> bytes:
    parts = [int(p) for p in dotted.split(".")]
    body = bytes([parts[0] * 40 + parts[1]])
    for p in parts[2:]:
        enc = []
        enc.append(p & 0x7F)
        p >>= 7
        while p:
            enc.append(0x80 | (p & 0x7F))
            p >>= 7
        body += bytes(reversed(enc))
    return tlv(OID, body)


def octet_string(b: bytes) -> bytes:
    return tlv(OCTET_STRING, b)


def bit_string(b: bytes) -> bytes:
    return tlv(BIT_STRING, b"\x00" + b)


def null() -> bytes:
    return tlv(NULL, b"")


def ctx(n: int, content: bytes, constructed: bool = True) -> bytes:
    return tlv(0xA0 | n if constructed else 0x80 | n, content)


# hash algorithm OIDs (NIST + legacy)
HASH_OIDS = {
    "1.3.14.3.2.26": 160,                 # sha1
    "2.16.840.1.101.3.4.2.4": 224,        # sha224
    "2.16.840.1.101.3.4.2.1": 256,        # sha256
    "2.16.840.1.101.3.4.2.2": 384,        # sha384
    "2.16.840.1.101.3.4.2.3": 512,        # sha512
}
HASH_OID_BY_BITS = {v: k for k, v in HASH_OIDS.items()}

SIG_OIDS = {
    "1.2.840.113549.1.1.5": ("rsa", 160),    # sha1WithRSA
    "1.2.840.113549.1.1.11": ("rsa", 256),   # sha256WithRSA
    "1.2.840.113549.1.1.12": ("rsa", 384),
    "1.2.840.113549.1.1.13": ("rsa", 512),
    "1.2.840.113549.1.1.10": ("rsapss", None),
    "1.2.840.10045.4.3.2": ("ecdsa", 256),   # ecdsa-with-SHA256
    "1.2.840.10045.4.3.1": ("ecdsa", 224),
    "1.2.840.10045.4.3.3": ("ecdsa", 384),
    "1.2.840.10045.4.1": ("ecdsa", 160),     # ecdsa-with-SHA1
}
OID_RSA_ENC = "1.2.840.113549.1.1.1"
OID_EC_PUBKEY = "1.2.840.10045.2.1"
OID_SIGNED_DATA = "1.2.840.113549.1.7.2"
OID_ICAO_LDS_SOD = "2.23.136.1.1.1"
OID_CONTENT_TYPE = "1.2.840.113549.1.9.3"
OID_MESSAGE_DIGEST = "1.2.840.113549.1.9.4"
