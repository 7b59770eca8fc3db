"""The port's threefry2x32 (poreseq_tpu_torch/engine/prng.py) against JAX's
installed one: the configuration it follows, Random123's known answers,
keys word for word, the Gumbel uniforms bit for bit and the Gumbel noise
within a stated tolerance, the twin's [nkeep, rows, 1024] layout, and the
pinned values that chip_smoke.py holds the card to."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poreseq_tpu_torch.engine import prng
from poreseq_tpu_torch.engine import viterbi as tv

torch.set_num_threads(1)

# (seed, k, i) -> the row key fold_in(split(PRNGKey(seed), nk)[k], i), and
# (row key, s) -> state s's 32-bit and 64-bit words (jax.random.bits with
# uint32 and uint64), computed with JAX (x64 for the 64-bit seed and
# words); chip_smoke.py holds the card to the same values
PINNED_KEYS = [((0, 0, 0), (4165894930, 804218099)),
               ((0, 15, 959), (1113189882, 2059144140)),
               ((7, 3, 99999), (4078193910, 4255733508)),
               ((2 ** 32 + 7, 5, 2 ** 31 - 1), (2330131653, 608189605))]
PINNED_WORDS = [((4165894930, 804218099), 0, 1214273199,
                 2933590336990503537),
                ((4165894930, 804218099), 511, 2782833415,
                 2631028836633797070),
                ((1113189882, 2059144140), 0, 168515629,
                 3676334643026570956),
                ((1113189882, 2059144140), 1023, 937218459,
                 11934964057838015240),
                ((4078193910, 4255733508), 0, 2224344565,
                 14285235530272315378),
                ((4078193910, 4255733508), 1023, 4001996215,
                 17772188034002510700)]

# Random123's known answers for threefry2x32_20: (key, counter) -> words
KNOWN = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
         ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
          (0x1CB996FC, 0xBB002BE7)),
         ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
          (0xC4923A9C, 0x483DF7A0))]

ROWS = [(0, 0), (3, 1), (4, 99999), (1, 2 ** 31 - 1)]   # (k, i), nk = 5
DTYPES = {"f32": (torch.float32, jnp.float32),
          "f64": (torch.float64, jnp.float64)}


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _words(key):
    """A JAX key's two uint32 words as Python ints."""
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


def test_jax_prng_config_is_the_ported_one():
    """The port follows threefry2x32 with partitionable splits and the
    low-range Gumbel: if the installed JAX changes any of them, this fails
    and the port's draws are no longer the JAX package's."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_high_dynamic_range_gumbel is False


@pytest.mark.parametrize("key,ctr,want", KNOWN)
def test_threefry_known_answers(key, ctr, want):
    """Random123's vectors, on Python ints and on int64 tensors."""
    assert prng.threefry2x32(*key, *ctr) == want
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    got = prng.threefry2x32(*(t(v) for v in key + ctr))
    assert tuple(int(g[0]) for g in got) == want


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 32 + 7])
def test_keys_equal_jax(seed, request):
    """prng_key, split and fold_in give JAX's words; seeds from 2^31 up run
    under x64, where JAX takes a 64-bit seed."""
    if seed >= 2 ** 31:
        request.getfixturevalue("x64")
    key = jax.random.PRNGKey(seed)
    assert prng.prng_key(seed) == _words(key)
    jk = jax.random.split(key, 5)
    k0, k1 = prng.split(prng.prng_key(seed), 5)
    assert [_words(k) for k in jk] == list(zip(k0.tolist(), k1.tolist()))
    for k, i in ROWS:
        assert prng.fold_in((int(k0[k]), int(k1[k])), i) == _words(
            jax.random.fold_in(jk[k], i))


def _row_key(seed, k, i):
    """The twin's row key of candidate k, row i, as int64 tensors [1, 1]."""
    k0, k1 = prng.split(prng.prng_key(seed), 5)
    return prng.fold_in((k0[k:k + 1, None], k1[k:k + 1, None]),
                        torch.tensor([[i]]))


def _jax_row_key(seed, k, i):
    return jax.random.fold_in(jax.random.split(jax.random.PRNGKey(seed),
                                               5)[k], i)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_uniforms_equal_jax_bit_for_bit(dt, seed, request):
    """The Gumbel draw's uniforms, jax.random.uniform(key, (1024,), dtype,
    minval=tiny, maxval=1.) under the row key, bit for bit at rows 0, 1,
    99999 and 2^31 - 1 (f64 under x64)."""
    if dt == "f64":
        request.getfixturevalue("x64")
    tdt, jdt = DTYPES[dt]
    for k, i in ROWS:
        want = np.asarray(jax.random.uniform(
            _jax_row_key(seed, k, i), (1024,), jdt,
            minval=jnp.finfo(jdt).tiny, maxval=1.0))
        got = prng.uniform(_row_key(seed, k, i), 1024, tdt)[0].numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                      want.view(f"u{want.itemsize}"))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_gumbel_twin_within_one_or_two_ulps_of_jax(dt, request):
    """gumbel_reference against jax.random.gumbel under the same keys, on
    16 candidates x 128 rows: |diff| <= 2 ulps of max(|g|, 1) (measured over
    21 M draws: 2 in f32, at most 9.5e-7; 1 in f64, at most 1.8e-15; the
    uniforms are equal, so only torch's log and XLA's differ), and most
    draws equal."""
    if dt == "f64":
        request.getfixturevalue("x64")
    tdt, jdt = DTYPES[dt]
    rows = np.arange(0, 640, 5)
    got = tv.gumbel_reference(7, 16, torch.as_tensor(rows), tdt).numpy()
    keys = jax.random.split(jax.random.PRNGKey(7), 16)
    draw = jax.vmap(jax.vmap(lambda key, i: jax.random.gumbel(
        jax.random.fold_in(key, i), (1024,), jdt), (None, 0)), (0, None))
    want = np.asarray(draw(keys, jnp.asarray(rows, jnp.int32)))
    assert got.shape == want.shape == (16, len(rows), 1024)
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(want.dtype))
    assert np.all(np.abs(got - want) <= 2 * ulp)
    assert np.mean(got == want) > (0.7 if dt == "f32" else 0.99)


def test_gumbel_twin_layout_and_rows():
    """gumbel_reference's [nkeep, n_rows, 1024]: candidate k's row r is the
    noise of row index rows[r], whatever rows it is given with."""
    full = tv.gumbel_reference(3, 4, torch.arange(70), torch.float64)
    some = tv.gumbel_reference(3, 4, torch.tensor([69, 0, 33]),
                               torch.float64)
    assert full.shape == (4, 70, 1024)
    assert torch.equal(some, full[:, [69, 0, 33]])
    one = prng.gumbel(_row_key(3, 2, 33), 1024, torch.float64)
    assert torch.equal(one[0], full[2, 33])
    with pytest.raises(ValueError, match="dtype"):
        tv.gumbel_reference(3, 4, torch.arange(2), torch.float16)


def test_pinned_values_equal_jax(x64):
    """The constants chip_smoke.py checks on the card are JAX's and the
    port's: the row keys, and state s's 32-bit word y0 ^ y1 and 64-bit word
    y0 << 32 | y1 of threefry2x32(row key, (0, s))."""
    for (seed, k, i), words in PINNED_KEYS:
        assert _words(jax.random.fold_in(jax.random.split(
            jax.random.PRNGKey(seed), 16)[k], i)) == words
        k0, k1 = prng.split(prng.prng_key(seed), 16)
        assert prng.fold_in((int(k0[k]), int(k1[k])), i) == words
    for words, s, w32, w64 in PINNED_WORDS:
        key = jax.random.wrap_key_data(np.array(words, np.uint32))
        assert int(jax.random.bits(key, (1024,), jnp.uint32)[s]) == w32
        assert int(jax.random.bits(key, (1024,), jnp.uint64)[s]) == w64
        y0, y1 = prng.threefry2x32(*words, 0, s)
        assert (y0 ^ y1, y0 << 32 | y1) == (w32, w64)
