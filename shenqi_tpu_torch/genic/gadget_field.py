"""Reference-exact Gaussian random field (N-GenIC/MP-GenIC phases).

Reproduces the reference's pmic_fill_gaussian_gadget
(libgenic/pmesh.h:65-180) bit-for-bit on the host with numpy:
boost::random::mt19937 streams (standard Knuth init_genrand seeding,
identical to boost's mt19937(seed)), boost uniform_real_distribution
on a 32-bit engine (one draw, x / 2^32 as double), the 8-fold
symmetric seedtable walk, and per-(i,j)-column amplitude/phase
sampling with hermitian-conjugate bookkeeping on the kz=0 and kz=N/2
planes.

With these phases a run from our ICs is the SAME realization as the
reference's CI examples, so their pinned outputs (dm-small's stored
top-30 FOF halo masses, star-small's star/BH counts) apply directly.

Everything here is one-time host work at IC generation; the heavy
FFT/displacement math stays in genic/ic.py on the TPU.

A copy of shenqi_tpu/genic/gadget_field.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package; tests/test_torch_genic_io.py pins it.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32


class MT19937Batch:
    """B independent Mersenne Twister streams, advanced in lockstep."""

    N, M = 624, 397
    MATRIX_A = _U32(0x9908B0DF)
    UPPER = _U32(0x80000000)
    LOWER = _U32(0x7FFFFFFF)

    def __init__(self, seeds):
        seeds = np.asarray(seeds, np.uint32)
        B = seeds.shape[0]
        mt = np.empty((self.N, B), np.uint32)
        mt[0] = seeds
        for i in range(1, self.N):
            prev = mt[i - 1]
            mt[i] = (_U32(1812433253) * (prev ^ (prev >> _U32(30)))
                     + _U32(i))
        self.mt = mt
        self.mti = self.N          # force twist on first draw

    def _twist(self):
        """Vectorized genrand twist.  The sequential reference updates
        in place, so entries past N-M read already-updated words —
        reproduced here with the standard three-phase split."""
        N, M = self.N, self.M
        old = self.mt
        U, L, A = self.UPPER, self.LOWER, self.MATRIX_A

        def step(y, src):
            mag = np.where((y & _U32(1)).astype(bool), A, _U32(0))
            return src ^ (y >> _U32(1)) ^ mag

        new = np.empty_like(old)
        y1 = (old[0:N - M] & U) | (old[1:N - M + 1] & L)
        new[0:N - M] = step(y1, old[M:N])
        # i in [N-M, N-1) reads new[i-(N-M)], itself written in this
        # phase for i >= 2(N-M): process in chunks of N-M
        for s in range(N - M, N - 1, N - M):
            e = min(s + (N - M), N - 1)
            y = (old[s:e] & U) | (old[s + 1:e + 1] & L)
            new[s:e] = step(y, new[s - (N - M):e - (N - M)])
        y3 = (old[N - 1] & U) | (new[0] & L)
        new[N - 1] = step(y3[None], new[M - 1][None])[0]
        self.mt = new
        self.mti = 0

    def next_u32(self):
        """One tempered 32-bit draw per stream -> [B] uint32."""
        if self.mti >= self.N:
            self._twist()
        y = self.mt[self.mti].copy()
        self.mti += 1
        y ^= y >> _U32(11)
        y ^= (y << _U32(7)) & _U32(0x9D2C5680)
        y ^= (y << _U32(15)) & _U32(0xEFC60000)
        y ^= y >> _U32(18)
        return y

    def uniform(self):
        """boost uniform_real_distribution<double>(0,1): x / 2^32."""
        return self.next_u32().astype(np.float64) / 4294967296.0

    def uniform_block(self, r):
        """[r, B] doubles, all streams advanced r draws in lockstep."""
        return np.stack([self.uniform() for _ in range(r)])


def _seedtable(nmesh: int, seed: int):
    """The 8-fold symmetric seed table (pmesh.h SETSEED loop order).

    Returns [2, 2, N, N] uint32.
    """
    n = nmesh
    rng = MT19937Batch(np.asarray([seed], np.uint32))
    table = np.zeros((2, 2, n, n), np.uint32)

    def setseed(i, j):
        s = _U32(int(0x7FFFFFFF * rng.uniform()[0]))
        ii = (i, (n - i) % n)
        jj = (j, (n - j) % n)
        for d1 in range(2):
            for d2 in range(2):
                table[d1, d2, ii[d1], jj[d2]] = s

    for i in range(n // 2):
        for j in range(i):
            setseed(i, j)
        for j in range(i + 1):
            setseed(j, i)
        for j in range(i):
            setseed(n - 1 - i, j)
        for j in range(i + 1):
            setseed(n - 1 - j, i)
        for j in range(i):
            setseed(i, n - 1 - j)
        for j in range(i + 1):
            setseed(j, n - 1 - i)
        for j in range(i):
            setseed(n - 1 - i, n - 1 - j)
        for j in range(i + 1):
            setseed(n - 1 - j, n - 1 - i)
    return table


def _column_samples(seeds, nk):
    """(phase, ampl) [nk, B] for B columns, one mt19937 stream each.

    SAMPLE (pmesh.h:56-62) per mode: phase = u * 2pi, then
    amplitude = u redrawn while exactly zero.  The zero-redraw breaks
    draw lockstep for that stream only — handled by a scalar replay
    of the affected stream (u == 0 has probability 2^-32 per draw, so
    replays are rare but DO occur at production draw counts).
    """
    rng = MT19937Batch(seeds)
    # slack words cover scalar replays' extra draws
    raw = rng.uniform_block(2 * nk + 8)          # [2nk+8, B]
    B = seeds.shape[0]
    phase = raw[0: 2 * nk: 2].copy()
    ampl = raw[1: 2 * nk + 1: 2].copy()
    bad = np.nonzero((raw[: 2 * nk] == 0.0).any(axis=0))[0]
    for b in bad:
        # exact scalar replay of this stream's rejection logic
        stream = MT19937Batch(seeds[b: b + 1])
        for m in range(nk):
            phase[m, b] = stream.uniform()[0]
            a = 0.0
            while a == 0.0:
                a = stream.uniform()[0]
            ampl[m, b] = a
    return phase * 2 * np.pi, ampl


def gadget_gaussian_field(seed: int, nmesh: int, unitary: bool = False,
                          invert_phase: bool = False,
                          row_chunk: int = 32) -> np.ndarray:
    """delta_k [N, N, N/2+1] complex128 with the reference's phases.

    Per (i,j) column two mt19937 streams run down kz: `this` (the
    [0,0] seed) and the hermitian-conjugate row's stream; on the
    kz=0 / kz=N/2 planes of conjugate-duty columns the conjugate
    stream's sample is used with negated imaginary part
    (pmesh.h:127-168).  Both streams always advance in lockstep with
    the reference's call order.
    """
    n = nmesh
    nk = n // 2 + 1
    table = _seedtable(n, seed)
    out = np.zeros((n, n, nk), np.complex128)
    kk = np.arange(nk)
    on_plane = (kk == 0) | (kk == n // 2)        # [nk]

    for i0 in range(0, n, row_chunk):
        rows = np.arange(i0, min(i0 + row_chunk, n))
        I, J = np.meshgrid(rows, np.arange(n), indexing="ij")
        I = I.ravel()
        J = J.ravel()
        ci = (n - I) % n
        cj = (n - J) % n
        d = (((ci == I) & (cj < J)) | ((ci < I) & (cj != J))
             | ((ci < I) & (cj == J))).astype(int)

        ph_t, am_t = _column_samples(table[0, 0, I, J], nk)
        ph_c, am_c = _column_samples(table[d, d, I, J], nk)

        use_conj = d.astype(bool)[None, :] & on_plane[:, None]
        phase = np.where(use_conj, ph_c, ph_t)     # [nk, B]
        ampl = np.where(use_conj, am_c, am_t)
        ampl = np.sqrt(-np.log(ampl))
        if unitary:
            ampl = np.ones_like(ampl)
        if invert_phase:
            phase = phase + np.pi
        re = ampl * np.cos(phase)
        im = ampl * np.sin(phase)
        im = np.where(use_conj, -im, im)
        # self-conjugate modes are real (set after the conj negation,
        # matching the reference's overwrite order)
        selfc = ((ci == I) & (cj == J))[None, :] & on_plane[:, None]
        im = np.where(selfc, 0.0, im)
        vals = re + 1j * im
        vals = np.where(((I == 0) & (J == 0))[None, :]
                        & (kk == 0)[:, None], 0.0, vals)   # DC
        out[I, J, :] = vals.T
    return out
