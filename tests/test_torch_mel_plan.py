"""The host side of the mel kernel (csrc/mel.cu) on the CPU: its tables
(``fft_table``, ``filter_ranges``) and a float32 numpy emulation of its
factorisation (the same radices 8 x 5 x 5, twiddle table, passes and real
split, in the kernel's order), held against float64 ``np.fft.rfft``, against
the JAX package's fused log-mel (Pallas in interpret mode) and against
planted faults. The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py check_mel)."""

import importlib

import numpy as np
import pytest
import torch

import qwen2_audio_tpu.audio as jaudio
from qwen2_audio_tpu_torch.audio.mel import hann_window, normalize, pad_signal
from qwen2_audio_tpu_torch.ops import mel_kernel as tmk

jmk = importlib.import_module("qwen2_audio_tpu.ops.mel_kernel")
MEL_ATOL = 3e-4   # tests/test_mel_kernel.py's tolerance for the fused kernel
# |X_emulated[k] - X_float64[k]| over sqrt(400) times the windowed frame's
# 2-norm, the bound of any |X[k]| (Cauchy-Schwarz): float32 rounding through
# three passes and the split (the emulation reads up to about 1.1e-7 on these
# frames); a wrong twiddle reads 1e-4 or more
FFT_REL = 1e-6

# --------------------------------------------------------------------------- #
# the emulation: csrc/mel.cu in float32 numpy, one row per frame
# --------------------------------------------------------------------------- #

f32 = np.float32


def _c(re, im):
    return (np.asarray(re, f32), np.asarray(im, f32))


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _mul(a, w):
    return (a[0] * w[0] - a[1] * w[1], a[0] * w[1] + a[1] * w[0])


def _dft4(a0, a1, a2, a3):
    s0, s1, s2, s3 = _add(a0, a2), _sub(a0, a2), _add(a1, a3), _sub(a1, a3)
    return [_add(s0, s2), (s1[0] + s3[1], s1[1] - s3[0]), _sub(s0, s2),
            (s1[0] - s3[1], s1[1] + s3[0])]


def _dft8(a):
    r = f32(0.70710678118654752)
    e, o = _dft4(a[0], a[2], a[4], a[6]), _dft4(a[1], a[3], a[5], a[7])
    o1 = (r * (o[1][0] + o[1][1]), r * (o[1][1] - o[1][0]))
    o2 = (o[2][1], -o[2][0])
    o3 = (r * (o[3][1] - o[3][0]), -r * (o[3][0] + o[3][1]))
    ow = [o[0], o1, o2, o3]
    return [_add(e[k], ow[k]) for k in range(4)] + [_sub(e[k], ow[k]) for k in range(4)]


def _dft5(a):
    c1, c2 = f32(0.30901699437494742), f32(-0.80901699437494742)
    s1, s2 = f32(0.95105651629515357), f32(0.58778525229247313)
    t1, t2, t3, t4 = _add(a[1], a[4]), _add(a[2], a[3]), _sub(a[1], a[4]), _sub(a[2], a[3])
    b1 = tuple(a[0][i] + c1 * t1[i] + c2 * t2[i] for i in range(2))
    b2 = tuple(a[0][i] + c2 * t1[i] + c1 * t2[i] for i in range(2))
    d1 = tuple(s1 * t3[i] + s2 * t4[i] for i in range(2))
    d2 = tuple(s2 * t3[i] - s1 * t4[i] for i in range(2))
    return [tuple(a[0][i] + t1[i] + t2[i] for i in range(2)),
            (b1[0] + d1[1], b1[1] - d1[0]), (b2[0] + d2[1], b2[1] - d2[0]),
            (b2[0] - d2[1], b2[1] + d2[0]), (b1[0] - d1[1], b1[1] + d1[0])]


def _slot(k: int) -> int:
    return 25 * (k % 8) + 5 * ((k // 8) % 5) + k // 40


def _split2(frames: np.ndarray, tab: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) float32 (F, 201) of 2 X: the kernel's passes over each (F,
    400) frame, up to its real split, which leaves the 1/2 to the power."""
    frames = np.asarray(frames, f32)
    win = tab[tmk.TAB_WINDOW:tmk.TAB_WINDOW + 400]
    w200 = [(tab[tmk.TAB_TW200 + 2 * j], tab[tmk.TAB_TW200 + 2 * j + 1]) for j in range(200)]
    w400 = [(tab[tmk.TAB_TW400 + 2 * k], tab[tmk.TAB_TW400 + 2 * k + 1]) for k in range(201)]
    xw = frames * win
    z = [None] * 200                       # the warp's 200 complex slots
    for n2 in range(25):                   # pass 1, lane n2
        a = _dft8([_c(xw[:, 2 * (25 * n1 + n2)], xw[:, 2 * (25 * n1 + n2) + 1])
                   for n1 in range(8)])
        z[n2] = a[0]
        for k1 in range(1, 8):
            z[25 * k1 + n2] = _mul(a[k1], w200[n2 * k1])
    for job in range(40):                  # pass 2: (k1, m2), in place
        base, m2 = 25 * (job // 5) + job % 5, job % 5
        a = _dft5([z[base + 5 * m1] for m1 in range(5)])
        z[base] = a[0]
        for j1 in range(1, 5):
            z[base + 5 * j1] = _mul(a[j1], w200[8 * m2 * j1])
    for job in range(40):                  # pass 3: (k1, j1), in place
        a = _dft5([z[5 * job + m2] for m2 in range(5)])
        for j2 in range(5):
            z[5 * job + j2] = a[j2]
    re, im = np.empty((len(frames), 201), f32), np.empty((len(frames), 201), f32)
    for k in range(201):                   # the real split, e - i W400^k d
        zk, zr = z[_slot(k % 200)], z[_slot((200 - k) % 200)]
        e = (zk[0] + zr[0], zk[1] - zr[1])
        d = (zk[0] - zr[0], zk[1] + zr[1])
        wd = _mul(d, w400[k])
        re[:, k], im[:, k] = e[0] + wd[1], e[1] - wd[0]
    return re, im


def emulate_rfft(frames: np.ndarray, tab: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) float32 (F, 201): the kernel's DFT of each (F, 400) frame."""
    re, im = _split2(frames, tab)
    return f32(0.5) * re, f32(0.5) * im


def emulate_mel_frames(padded: np.ndarray, n_frames: int, tab, ranges, weights) -> np.ndarray:
    """(n_frames, n_mel) float32 log10 mel, as the kernel computes it."""
    frames = np.lib.stride_tricks.sliding_window_view(
        np.asarray(padded, f32), 400)[::160][:n_frames]
    re, im = _split2(frames, tab)
    power = f32(0.25) * (re * re + im * im)
    out = np.empty((n_frames, len(ranges)), f32)
    for m, (lo, hi, off, _) in enumerate(ranges):
        acc = np.zeros(n_frames, f32)
        for b in range(lo, hi):
            acc = acc + power[:, b] * weights[off + b - lo]
        out[:, m] = np.log10(np.maximum(acc, f32(1e-10)))
    return out


# --------------------------------------------------------------------------- #
# checks, each returning the measure its test bounds (so the faults can be
# shown to fail them)
# --------------------------------------------------------------------------- #

def rfft_error(frames: np.ndarray, tab: np.ndarray) -> float:
    """max over frames and bins of |emulated - float64 rfft| over sqrt(400)
    ||windowed frame||."""
    re, im = emulate_rfft(frames, tab)
    xw = frames.astype(np.float64) * hann_window().astype(np.float64)
    want = np.fft.rfft(xw, axis=-1)
    err = np.abs(re.astype(np.float64) + 1j * im.astype(np.float64) - want)
    norm = np.maximum(np.sqrt(400) * np.linalg.norm(xw, axis=-1, keepdims=True), 1e-30)
    return float((err / norm).max())


def range_faults(filters: np.ndarray, ranges: np.ndarray, weights: np.ndarray) -> list[str]:
    """What is wrong with (ranges, weights) for this filterbank: a nonzero
    outside its range, a range wider than its nonzeros, a weight or an offset
    that is not the filterbank's."""
    faults, off = [], 0
    for m, (lo, hi, o, pad) in enumerate(ranges):
        nz = np.flatnonzero(filters[m])
        if pad != 0 or o != off or not 0 <= lo <= hi <= filters.shape[1]:
            faults.append(f"mel {m}: bad entry {(lo, hi, o, pad)}")
        elif nz.size and (nz[0] < lo or nz[-1] >= hi):
            faults.append(f"mel {m}: nonzero outside [{lo}, {hi})")
        elif (nz.size and (nz[0] != lo or nz[-1] != hi - 1)) or (not nz.size and hi > lo):
            faults.append(f"mel {m}: range [{lo}, {hi}) wider than its nonzeros")
        elif not np.array_equal(weights[o:o + hi - lo], filters[m, lo:hi]):
            faults.append(f"mel {m}: weights differ")
        off += hi - lo
    return faults


def compact_product(power: np.ndarray, ranges, weights) -> np.ndarray:
    """(F, n_mel) float64: the filterbank product over the ranges alone."""
    out = np.zeros((power.shape[0], len(ranges)))
    for m, (lo, hi, off, _) in enumerate(ranges):
        out[:, m] = power[:, lo:hi] @ weights[off:off + hi - lo].astype(np.float64)
    return out


# --------------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------------- #

def _clip(seconds, rng):
    n = int(16000 * seconds)
    return (0.4 * np.sin(2 * np.pi * 440 * np.arange(n) / 16000)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _frames(kind: str, rng, n: int = 24) -> np.ndarray:
    t = np.arange(400)
    if kind == "noise":            # full-scale white noise
        return rng.uniform(-1, 1, (n, 400)).astype(np.float32)
    if kind == "bin tone":         # centred on bin 37: the window leaves bins 36..38
        return np.tile(np.cos(2 * np.pi * 37 * t / 400), (n, 1)).astype(np.float32)
    if kind == "speechlike":
        padded, _, _, c = pad_signal(_clip(1.0, rng))
        return np.lib.stride_tricks.sliding_window_view(padded, 400)[::160][:c]
    return np.zeros((n, 400), np.float32)


def _banks(rng) -> dict:
    dense = rng.uniform(0, 1, (64, 201)).astype(np.float32)
    holes = dense.copy()
    holes[3] = 0                                  # an empty row
    holes[5, :50] = holes[5, 120:] = 0            # a row with interior zeros kept
    holes[5, 80:90] = 0
    holes[7, 0] = holes[7, -1] = 1.0              # a full row
    return {"slaney80": jaudio.mel_filterbank(80), "slaney128": jaudio.mel_filterbank(128),
            "dense": dense, "holes": holes, "empty": np.zeros((4, 201), np.float32)}


# --------------------------------------------------------------------------- #
# tests
# --------------------------------------------------------------------------- #

def test_fft_table_is_float64_rounded_once():
    tab = tmk.fft_table()
    assert tab.dtype == np.float32 and tab.shape == (tmk.TAB_LEN,)
    np.testing.assert_array_equal(tab[:400], hann_window())
    for at, n, count in ((tmk.TAB_TW200, 200, 200), (tmk.TAB_TW400, 400, 201)):
        ang = 2 * np.pi * np.arange(count, dtype=np.float64) / n
        np.testing.assert_array_equal(tab[at:at + 2 * count:2], np.cos(ang).astype(np.float32))
        np.testing.assert_array_equal(tab[at + 1:at + 2 * count:2],
                                      (-np.sin(ang)).astype(np.float32))
    assert not tab[tmk.TAB_TW400 + 2 * 201:].any()


def test_design_flops():
    # the count the kernel's note and PERF.md state; 33x below the dense DFT's
    assert tmk.FFT_FLOPS_PER_FRAME == 10546
    assert 400 * 402 * 2 / tmk.FFT_FLOPS_PER_FRAME > 30


@pytest.mark.parametrize("bank", ["slaney80", "slaney128", "dense", "holes", "empty"])
def test_filter_ranges_exact(bank, rng):
    filters = _banks(rng)[bank]
    ranges, weights = tmk.filter_ranges(filters)
    assert ranges.dtype == np.int32 and ranges.shape == (len(filters), 4)
    assert weights.dtype == np.float32 and weights.size >= 1
    assert range_faults(filters, ranges, weights) == []
    power = rng.uniform(0, 1, (16, 201))
    np.testing.assert_allclose(compact_product(power, ranges, weights),
                               power @ filters.T.astype(np.float64), rtol=1e-12, atol=0)
    if bank.startswith("slaney"):
        # a Slaney bin lies in at most two triangles
        assert (ranges[:, 1] - ranges[:, 0]).sum() <= 2 * 201
    if bank == "holes":
        assert tuple(ranges[3, :2]) == (0, 0) and tuple(ranges[7, :2]) == (0, 201)


@pytest.mark.parametrize("cut", ["lo", "hi"])
def test_short_range_fails(cut, rng):
    filters = jaudio.mel_filterbank(80)
    ranges, weights = tmk.filter_ranges(filters)
    bad = ranges.copy()
    m = 40
    if cut == "lo":
        bad[m, 0] += 1
    else:
        bad[m, 1] -= 1
    assert range_faults(filters, bad, weights)
    power = rng.uniform(0.5, 1, (4, 201))
    got = compact_product(power, bad, weights)
    want = power @ filters.T.astype(np.float64)
    assert not np.allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind", ["noise", "bin tone", "speechlike", "silence"])
def test_emulated_fft_matches_float64_rfft(kind, rng):
    frames = _frames(kind, rng)
    err = rfft_error(frames, tmk.fft_table())
    assert err <= FFT_REL, err
    if kind == "silence":
        re, im = emulate_rfft(frames, tmk.fft_table())
        assert not re.any() and not im.any()


@pytest.mark.parametrize("entry", [("tw200", 1), ("tw200", 35), ("tw200", 128), ("tw400", 1),
                                   ("tw400", 150), ("window", 100)])
def test_wrong_twiddle_fails(entry, rng):
    which, j = entry
    tab = tmk.fft_table().copy()
    at = {"tw200": tmk.TAB_TW200 + 2 * j + 1, "tw400": tmk.TAB_TW400 + 2 * j + 1,
          "window": tmk.TAB_WINDOW + j}[which]
    tab[at] = -tab[at] if tab[at] else 0.5      # a sign error, or a zero made nonzero
    err = rfft_error(_frames("noise", rng), tab)
    assert err > 100 * FFT_REL, err


@pytest.mark.parametrize("seconds,n_mels", [(1.0, 80), (2.7, 80), (1.0, 128), (2.7, 128)])
def test_emulation_matches_jax_pallas(seconds, n_mels, rng):
    """The emulated kernel through normalize against the TPU kernel in
    interpret mode, as tests/test_torch_mel.py holds the plain version."""
    x = _clip(seconds, rng)
    filters = jaudio.mel_filterbank(n_mels)
    padded, n_len, _, n_content = pad_signal(x)
    ranges, weights = tmk.filter_ranges(filters)
    content = emulate_mel_frames(padded, n_content, tmk.fft_table(), ranges, weights)
    got = normalize(torch.from_numpy(content), n_len).numpy()
    want = jmk.log_mel_spectrogram_fused(x, filters)
    assert got.shape == want.data.shape
    np.testing.assert_allclose(got, want.data, atol=MEL_ATOL)


def test_emulation_matches_plain_version(rng):
    """The emulation's raw log10 frames against the plain version's on the
    CPU (the card's check holds the kernel to the same plain version)."""
    padded, _, _, n = pad_signal(_clip(1.0, rng))
    filters = jaudio.mel_filterbank(128)
    tables = tmk.mel_tables(filters, "cpu")
    want = tmk.mel_frames_plain(torch.from_numpy(padded), tables, n).numpy()
    got = emulate_mel_frames(padded, n, tables.fft_tab.numpy(), tables.ranges.numpy(),
                             tables.weights.numpy())
    np.testing.assert_allclose(got, want, atol=4 * MEL_ATOL)


def test_mel_tables_hold_kernel_and_plain_tables():
    tables = tmk.mel_tables(jaudio.mel_filterbank(80), "cpu")
    assert tables.n_mel == 80
    assert tables.fft_tab.dtype == torch.float32 and tables.fft_tab.shape == (tmk.TAB_LEN,)
    assert tables.ranges.dtype == torch.int32 and tables.ranges.shape == (80, 4)
    assert tables.weights.dtype == torch.float32
    assert tables.wcos.shape == (400, 201) and tables.filt_t.shape == (201, 80)


def test_filter_ranges_rejects_other_widths():
    with pytest.raises(ValueError):
        tmk.filter_ranges(np.ones((8, 200), np.float32))
