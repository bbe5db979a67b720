"""The port's SHA R1CS gadgets (``circuit/sha``, ``sha1``, ``sha512``)
against the JAX package's, tolerance 0: SHA-1, SHA-384 and SHA-512 on one
padded block each at batch 2, built by both packages on the same seeded
messages (``torch_lowering_pair``), the digests also against hashlib; and
the SHA-512 round constants and IVs the two copies read.

The JAX package's ``ops/sha2`` and ``circuit/sha512`` each compute the 80
round constants at import by a cube root that steps one unit at a time
(about 11 s together on a CPU core); the first case here pays it.
"""

import hashlib
import random

import pytest
import torch

from passport_zk_circuits_tpu_torch.ingest import native

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)
from torch_lowering_pair import (BATCH, JAX, PORT, assert_equal_circuits,
                                 build_both, mods)

torch.set_num_threads(1)


def _bit_inputs(b, words):
    """Boolean input wires of (n_words, B) uint32 words, MSB first."""
    bits = []
    for w in range(words.shape[0]):
        for i in range(31, -1, -1):
            s = b.input([(int(v) >> i) & 1 for v in words[w]], "msg")
            b.enforce_bool(s)
            bits.append(s)
    return bits


@pytest.mark.parametrize("algo, hname", [(160, "sha1"), (384, "sha384"),
                                         (512, "sha512")])
def test_sha_gadget_equals_jax_and_hashlib(algo, hname):
    rng = random.Random(algo)
    block = 1024 if algo in (384, 512) else 512
    msgs = [rng.randbytes(block // 8 - 28) for _ in range(BATCH)]
    words = native.pad_words32_batch(msgs, block, 1)
    digests = {}

    def make(pkg, b):
        sha, = mods(pkg, "sha")
        assert sha.block_bits(algo) == block
        digests[pkg] = [s.ints() for s in
                        sha.sha_hash_chunks(b, _bit_inputs(b, words), algo)]
        return []

    assert_equal_circuits(build_both(make))
    assert digests[PORT] == digests[JAX] and len(digests[PORT]) == algo
    for lane in range(BATCH):
        bits = [s[lane] for s in digests[PORT]]
        got = bytes(sum(bits[8 * i + k] << (7 - k) for k in range(8))
                    for i in range(algo // 8))
        assert got == hashlib.new(hname, msgs[lane]).digest()


def test_sha512_constants_equal_jax():
    mine, theirs = (mods(pkg, "sha512")[0] for pkg in (PORT, JAX))
    assert len(mine._K) == 80
    assert (mine._K, mine._IV512, mine._IV384) == \
        (theirs._K, theirs._IV512, theirs._IV384)
