"""Host padding of SHA messages for the circuit lowering.

The port's counterpart of ``passport_zk_circuits_tpu/ingest/native.py``'s
``pad_words32_batch``, the one function of it that
``circuit/register_light.py`` calls. Only its pure-Python route is here;
the g++ batcher of the JAX package is not ported (it is set-up cost, and
its outputs equal this route's).
"""

from __future__ import annotations

import numpy as np

from ..ops import sha2


def pad_words32_batch(blobs, block_bits: int, n_blocks: int) -> np.ndarray:
    """Pad B blobs MD-style and pack big-endian 32-bit words.

    Returns (n_blocks*block_bits/32, B) uint32, batch minor-most; a blob
    that does not pad to exactly n_blocks blocks raises ValueError."""
    n_words = n_blocks * block_bits // 32
    cols = []
    for b in blobs:
        padded = sha2.pad_message(b, block_bits)
        if len(padded) * 8 != n_blocks * block_bits:
            raise ValueError(
                f"blob of {len(b)}B does not pad to exactly "
                f"{n_blocks} x {block_bits}-bit blocks")
        cols.append(sha2.bytes_to_words32(padded))
    return (np.stack(cols, axis=-1) if cols
            else np.empty((n_words, 0), dtype=np.uint32))
