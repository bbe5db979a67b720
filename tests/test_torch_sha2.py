"""The port's SHA-1/224/256/384/512 against hashlib and the JAX package.

The JAX package's SHA tests are slow-tier on the CPU (XLA compiles of
every SHA width), so most fast tests hold the port's plain version against
the oracle the JAX tests use, hashlib, and against the JAX package's
host-side padding; the many-message entry of the witness step is also held
against the live JAX SHA-224/256 at B = 5 (about a second of compiles), and
a slow-tier test runs the live JAX function on other words.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import sha2 as jsha2
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import bitops
from passport_zk_circuits_tpu_torch.ops import cuda_sha2
from passport_zk_circuits_tpu_torch.ops import sha2

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

rng = random.Random(2202)


def _batch(msgs, block_bits=512):
    """Equal-block-count messages -> padded 32-bit word tensor (n, B)."""
    return bn.to_tensor(np.stack(
        [sha2.bytes_to_words32(sha2.pad_message(m, block_bits))
         for m in msgs], axis=-1), "cpu")


def _digests(words):
    return [b"".join(int(v).to_bytes(4, "big") for v in col)
            for col in words.T.tolist()]


def test_padding_matches_jax():
    for n in (0, 1, 55, 56, 63, 64, 119, 200):
        m = bytes(rng.randrange(256) for _ in range(n))
        for block in (512, 1024):
            assert sha2.pad_message(m, block) == jsha2.pad_message(m, block)
        np.testing.assert_array_equal(
            sha2.bytes_to_words32(sha2.pad_message(m, 512)),
            jsha2.bytes_to_words32(jsha2.pad_message(m, 512)))


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_sha256_sha224_match_hashlib(nb):
    msgs = [bytes(rng.randrange(256) for _ in range(64 * nb - 9 - j))
            for j in range(4)]
    words = _batch(msgs)
    assert (words >= 1 << 31).any()
    assert _digests(sha2.sha256_chunks(words)) == \
        [hashlib.sha256(m).digest() for m in msgs]
    assert _digests(sha2.sha_hash_chunks(words, 224)) == \
        [hashlib.sha224(m).digest() for m in msgs]


def test_batch_dims_and_wrapper_contract():
    msgs = [bytes([i]) * 10 for i in range(6)]
    words = _batch(msgs)
    out = sha2.sha256_chunks(words.reshape(16, 2, 3))
    assert out.shape == (8, 2, 3)
    torch.testing.assert_close(out.reshape(8, 6), sha2.sha256_chunks(words),
                               rtol=0, atol=0)
    # on a CPU tensor the wrapper takes the plain version, and counts no
    # kernel launch
    before = cuda_sha2.sha2_32_chunks.launches
    torch.testing.assert_close(cuda_sha2.sha2_32_chunks(words),
                               cuda_sha2.sha2_32_chunks_plain(words),
                               rtol=0, atol=0)
    assert cuda_sha2.sha2_32_chunks.launches == before
    with pytest.raises(ValueError):
        cuda_sha2.sha2_32_chunks(words, 512)
    # the facade takes every width: SHA-1 on the same words, SHA-384/512 on
    # 1024-bit blocks as hi/lo pairs
    assert _digests(sha2.sha_hash_chunks(words, 160)) == \
        [hashlib.sha1(m).digest() for m in msgs]
    for algo in (384, 512):
        w64 = bitops.words32_to_words64(_batch(msgs, 1024))
        dw = sha2.sha_hash_chunks(w64, algo)
        assert dw.shape == (algo // 64, 2, 6)
        assert _digests(dw.reshape(algo // 32, 6)) == \
            [hashlib.new(f"sha{algo}", m).digest() for m in msgs]
    with pytest.raises(ValueError):
        sha2.sha_hash_chunks(words, 257)


@pytest.mark.parametrize("with_dg15", [False, True])
def test_many_matches_jax_per_message_and_hashlib(with_dg15):
    """sha_hash_chunks_many, the witness step's one call, on the step's
    messages (dg1, dg15, ec, sa of nb 2, 3, 4, 2; dg15 only with active
    auth) with SA under SHA-224 and EC under SHA-256 as SIG_ALGO 24 hashes
    them, at B = 5: equal to the JAX package's SHA-224/256 (its
    sha_hash_chunks, which on the CPU takes the XLA path that the JAX tests
    hold equal to the Pallas sha2_32_chunks; the kernel itself, interpreted,
    takes minutes for one block), to the port's per-message entry and to
    hashlib. On CPU tensors the wrapper counts no launch."""
    nbs, algos = [2, 3, 4, 2], [256, 256, 256, 224]
    if not with_dg15:
        nbs, algos = nbs[:1] + nbs[2:], algos[:1] + algos[2:]
    texts = [[bytes(rng.randrange(256) for _ in range(
        64 * nb - 9 - rng.randrange(40))) for _ in range(5)] for nb in nbs]
    words = [_batch(ms) for ms in texts]
    before = cuda_sha2.sha2_32_chunks_many.launches
    got = sha2.sha_hash_chunks_many(words, algos)
    assert cuda_sha2.sha2_32_chunks_many.launches == before
    assert len(got) == len(words)
    for out, w, algo, ms in zip(got, words, algos, texts):
        torch.testing.assert_close(out, sha2.sha_hash_chunks(w, algo),
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jsha2.sha_hash_chunks(
                w.numpy().astype(np.uint32), algo)).astype(np.int64))
        assert _digests(out) == [hashlib.new(f"sha{algo}", m).digest()
                                 for m in ms]


def test_many_contract():
    words = _batch([bytes([i]) * 10 for i in range(6)])
    out = sha2.sha_hash_chunks_many([words.reshape(16, 2, 3)] * 2, [256, 224])
    assert [o.shape for o in out] == [(8, 2, 3), (7, 2, 3)]
    torch.testing.assert_close(out[1].reshape(7, 6),
                               sha2.sha_hash_chunks(words, 224),
                               rtol=0, atol=0)
    # K1's many-message entry hashes SHA-224/256 only
    for algos in ([256, 160], [384], [512, 256]):
        with pytest.raises(ValueError):
            sha2.sha_hash_chunks_many([words] * len(algos), algos)
    with pytest.raises(ValueError):
        cuda_sha2.sha2_32_chunks_many([words] * 5, [256] * 5)
    with pytest.raises(ValueError):
        cuda_sha2.sha2_32_chunks_many([words, words[:, :5]], [256, 256])
    with pytest.raises(ValueError):
        cuda_sha2.sha2_32_chunks_many([words], [512])


# the boundary lengths of tests/test_sha.py: empty, one block, the last
# length whose padding fits the block, the first that does not, a full block
BOUNDARY = {160: (0, 3, 55, 56, 64), 224: (0, 3, 55, 56, 64),
            256: (0, 3, 55, 56, 64), 384: (0, 3, 111, 112, 128),
            512: (0, 3, 111, 112, 128)}


@pytest.mark.parametrize("algo", sorted(BOUNDARY))
def test_every_width_matches_hashlib_on_boundary_lengths(algo):
    block = sha2.ALGO_BITS[algo]
    for n in BOUNDARY[algo]:
        msgs = [bytes(rng.randrange(256) for _ in range(n)) for _ in range(3)]
        words = _batch(msgs, block)
        if algo in (384, 512):
            words = bitops.words32_to_words64(words)
        dw = sha2.sha_hash_chunks(words, algo)
        assert dw.shape[0] == sha2.DIGEST_WORDS[algo]
        assert _digests(dw.reshape(-1, 3)) == \
            [sha2.sha_hash_bytes_host(m, algo) for m in msgs], (algo, n)


@pytest.mark.parametrize("algo", sorted(BOUNDARY))
def test_byte_rows_match_hashlib_and_jax_padding(algo):
    """sha_hash_byte_rows, the hash of a stream built on the device (MGF1,
    M'), on a mix of per-byte tensor rows and int constants; its padding
    equals the JAX package's pad_byte_rows."""
    for n in (0, 40, BOUNDARY[algo][3]):
        rows = [torch.tensor([rng.randrange(256) for _ in range(4)])
                if rng.random() < .7 else rng.randrange(256)
                for _ in range(n)]
        assert len(sha2.pad_byte_rows(rows, sha2.ALGO_BITS[algo])) == \
            len(jsha2.pad_byte_rows(rows, sha2.ALGO_BITS[algo]))
        ints = [r if isinstance(r, int) else 0 for r in rows]
        assert [r for r in sha2.pad_byte_rows(ints, sha2.ALGO_BITS[algo])] \
            == jsha2.pad_byte_rows(ints, sha2.ALGO_BITS[algo])
        out = sha2.sha_hash_byte_rows(rows, algo, (4,))
        assert out.shape == (algo // 8, 4)
        for lane in range(4):
            data = bytes(int(r[lane]) if isinstance(r, torch.Tensor) else r
                         for r in rows)
            assert bytes(out[:, lane].tolist()) == \
                sha2.sha_hash_bytes_host(data, algo)


@pytest.mark.slow
def test_sha256_matches_live_jax():
    msgs = [bytes(rng.randrange(256) for _ in range(100)) for _ in range(3)]
    words_np = np.stack([jsha2.bytes_to_words32(jsha2.pad_message(m, 512))
                         for m in msgs], axis=-1)
    np.testing.assert_array_equal(
        sha2.sha256_chunks(bn.to_tensor(words_np, "cpu")).numpy(),
        np.asarray(jsha2.sha256_chunks(words_np)))
