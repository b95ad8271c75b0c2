#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``m3f_torch``) on one GPU.

Run from the repository root with no arguments on a machine with an NVIDIA
H100 (``python3 chip_smoke.py``). It

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   kernel of the serving path from ``m3f_torch/csrc`` (one ``nvcc`` per
   source, all at once);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the full-width ``longseq_eval`` forward gives it, and times the
   kernel, the plain version and one PyTorch yardstick call with CUDA events
   (median of 20); the conv units' channel sums are held per channel, and
   the same check is shown to refuse a zeroed, channel-shifted or
   partial-tile-short s1; then checks each kernel at a few shapes off the
   main path's tiling (masked edges);
3. serves a synthetic 1024-frame video through ``Predictor(preset=
   "longseq_eval")`` at full width with seeded random weights: a 30 fps
   request, a 25 fps request (per-video mel hop) and a chunked one
   (``window.eval_max_windows=64``), each with the launch counters set to 0
   just before and read just after; every kernel must have launched;
4. runs the same weights of a narrow model through the port on the CPU
   (plain versions) and on the card (kernels) and compares the predictions;
5. prints the ``kernels`` line, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero. Without a GPU, or without the package next
to this file, it exits non-zero before printing any result. TF32 is off for
every comparison.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

# Tolerances, stated before the run:
MEL_ATOL = 5e-3          # log domain, fp32 (tests/test_melspec_pallas.py:41)
GRU_ATOL_F32 = 1e-5      # fp32 recurrence (tests/test_gru_pallas.py:21-22)
GRU_ATOL_BF16 = 2 ** -6  # bf16 x/W: a bf16 round of h@W_hh can flip by one
#                          ulp with the fp32 summation order (4 ulps at |h|=1)
CONV_Y_REL = 2 ** -7     # bf16 y: one ulp from the fp32 summation order ...
CONV_Y_ABS = 1e-5        # ... plus a floor, relative to max|y|, near zero
CONV_S_REL = 1e-5        # channel sums, per channel: fp32 summation order,
#                          relative to sum|y| and to s2 (see sum_limits)
CONV_BM = 128            # the conv kernel's row tile (BM in conv_bn.cu)
PATH_ATOL = 3e-2         # whole-path bf16 preds (tanh outputs), card vs CPU
PATH_MEAN_ATOL = 5e-3
CHUNK_ATOL = 3e-2        # fused vs chunked eval of one video on the card

PEAK_BF16 = 989e12       # H100 SXM dense bf16 tensor rate, FLOP/s
PEAK_FP32 = 67e12        # H100 SXM fp32 rate outside the tensor cores
HBM = 3.35e12            # H100 SXM memory rate, B/s


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def require(cond, msg):
    if not cond:
        fail(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed(torch, fn, reps=20):
    """Median ms of ``reps`` calls, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_mel(torch, melspec, cfg):
    """K1 at the main path's shapes: 128 rows of 7995 samples (static hop)
    and 128 rows of 10005 samples (per-row hop 640, the 25 fps request)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    wav = torch.randn(128, 7995, device="cuda", generator=g) * 0.3
    err = (melspec.log_mel_spectrogram(wav, cfg)
           - melspec.log_mel_spectrogram_reference(wav, cfg)).abs().max().item()
    wav_d = torch.randn(128, 10005, device="cuda", generator=g) * 0.3
    hops = torch.full((128,), 640, dtype=torch.int32, device="cuda")
    err_d = (melspec.log_mel_spectrogram(wav_d, cfg, hop=hops, n_frames_out=16)
             - melspec.log_mel_spectrogram_reference(
                 wav_d, cfg, hop=hops, n_frames_out=16)).abs().max().item()
    require(err <= MEL_ATOL and err_d <= MEL_ATOL,
            f"mel kernel vs plain: static {err}, dynamic {err_d} > {MEL_ATOL}")
    bf = torch.bfloat16
    ms = timed(torch, lambda: melspec.log_mel_spectrogram(wav, cfg, bf))
    plain = timed(torch, lambda: melspec.log_mel_spectrogram_reference(wav, cfg, bf))
    win = torch.hann_window(cfg.win_length, periodic=True, device="cuda")
    fb = torch.from_numpy(melspec.mel_filterbank(cfg)).cuda()

    def library():
        spec = torch.stft(wav, cfg.n_fft, cfg.hop_length, window=win,
                          center=True, pad_mode="reflect", return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2               # [N, bins, F]
        return torch.log(power.transpose(1, 2) @ fb + cfg.log_eps).to(bf)
    lib = timed(torch, library)
    # The function's own work, whatever the algorithm: per frame the window,
    # a real FFT (5/2 n log2 n), the power of each bin, the mel product and
    # the log; bytes are the wav in and the log-mel out (constants such as
    # the filterbank are not inputs).
    frames, n, bins = 128 * 16, cfg.n_fft, cfg.n_fft // 2 + 1
    flops = frames * (n + 2.5 * n * math.log2(n) + 3 * bins
                      + 2 * bins * cfg.n_mels + cfg.n_mels)
    nbytes = wav.numel() * 4 + frames * cfg.n_mels * 2
    b_ms, b_by = bound(nbytes, flops, PEAK_FP32)
    emit({"phase": "kernel_melspec", "max_abs_err": err, "max_abs_err_dynamic_hop": err_d,
          "tol": MEL_ATOL, "ms": ms, "plain_ms": plain, "library_ms": lib,
          "bound_ms": b_ms})
    return {"name": "melspec", "max_abs_err": max(err, err_d), "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib}


def check_gru(torch, gru):
    """K2 at the main path's shapes: B=16 sequences, T=128, H=256, both
    directions, bf16 x_proj and W_hh (gru.backend="xla"); fp32 too."""
    B, T, H, D = 16, 128, 256, 2
    g = torch.Generator(device="cuda").manual_seed(2)
    xp = torch.randn(B, T, D, 3 * H, device="cuda", generator=g)
    w = torch.randn(D, H, 3 * H, device="cuda", generator=g) / math.sqrt(H)
    b = torch.randn(D, 3 * H, device="cuda", generator=g) * 0.1
    err32 = (gru.gru_scan(xp, w, b)
             - gru.gru_scan_reference(xp, w, b)).abs().max().item()
    bf = torch.bfloat16
    xb, wb = xp.to(bf), w.to(bf)
    err16 = (gru.gru_scan(xb, wb, b).float()
             - gru.gru_scan_reference(xb, wb, b).float()).abs().max().item()
    require(err32 <= GRU_ATOL_F32 and err16 <= GRU_ATOL_BF16,
            f"gru kernel vs plain: fp32 {err32} (tol {GRU_ATOL_F32}), bf16 "
            f"{err16} (tol {GRU_ATOL_BF16})")
    ms = timed(torch, lambda: gru.gru_scan(xb, wb, b))
    plain = timed(torch, lambda: gru.gru_scan_reference(xb, wb, b))
    ref = torch.nn.GRU(768, H, batch_first=True, bidirectional=True).cuda().to(bf)
    ref.flatten_parameters()
    x_in = torch.randn(B, T, 768, device="cuda", generator=g).to(bf)
    with torch.no_grad():
        lib = timed(torch, lambda: ref(x_in))
    flops = 2 * D * T * B * H * 3 * H
    nbytes = xb.numel() * 2 + wb.numel() * 2 + b.numel() * 4 + B * T * D * H * 2
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
    emit({"phase": "kernel_gru", "max_abs_err_bf16": err16, "tol_bf16": GRU_ATOL_BF16,
          "max_abs_err_fp32": err32, "tol_fp32": GRU_ATOL_F32, "ms": ms,
          "plain_ms": plain, "library_ms_nn_gru_incl_input_proj": lib,
          "bound_ms": b_ms})
    return {"name": "gru", "max_abs_err": err16, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def sum_limits(y, y0, s20):
    """Per output channel, how far the conv unit's sums may lie from the
    plain version's: the channel's sum of |y - y0| (of |y^2 - y0^2|), i.e.
    the one-ulp differences of y that are held per element, plus CONV_S_REL
    of sum|y0| (of s20) for the fp32 summation order."""
    dims = tuple(range(y.dim() - 1))
    yf, y0f = y.float(), y0.float()
    lim1 = (yf - y0f).abs().sum(dims) + CONV_S_REL * y0f.abs().sum(dims) + 1e-6
    lim2 = (yf * yf - y0f * y0f).abs().sum(dims) + CONV_S_REL * s20 + 1e-6
    return lim1, lim2


def sums_within(s1, s2, s10, s20, lims):
    return bool(((s1 - s10).abs() <= lims[0]).all()
                and ((s2 - s20).abs() <= lims[1]).all())


def check_sums(what, y, y0, s1, s2, s10, s20):
    """Holds the sums per channel, then shows that the same check refuses a
    kernel whose s1 is zero, lies one channel off, or leaves out the rows
    of a last partial row tile. Returns the worst |s1 - s10| / limit."""
    lims = sum_limits(y, y0, s20)
    require(sums_within(s1, s2, s10, s20, lims),
            f"{what}: channel sums off by s1 {(s1 - s10).abs().max().item()}, "
            f"s2 {(s2 - s20).abs().max().item()}")
    wrong = {"s1_zero": s1 * 0, "s1_one_channel_off": s1.roll(1)}
    partial = math.prod(y.shape[:-1]) % CONV_BM
    if partial:
        wrong["s1_partial_tile_left_out"] = \
            s1 - y.reshape(-1, y.shape[-1])[-partial:].float().sum(0)
    passed = [k for k, v in wrong.items() if sums_within(v, s2, s10, s20, lims)]
    require(not passed, f"{what}: the sums check would pass a wrong s1: {passed}")
    return ((s1 - s10).abs() / lims[0]).max().item()


def _conv_units():
    """(kind, x shape, w shape, affine, copies per forward) of every fused
    unit of the full-width forward over 128 clips: 5 fused blocks (two in
    stage 1), each conv1 (spatial, no prologue; temporal) and conv2
    (spatial and temporal, both with the BN prologue)."""
    units = []
    for c, t, s, n in ((64, 16, 56, 2), (128, 8, 28, 1), (256, 4, 14, 1),
                       (512, 2, 7, 1)):
        mid = (27 * c * c) // (9 * c + 3 * c)
        units += [("spatial", (128, t, s, s, c), (3, 3, c, mid), False, n),
                  ("spatial", (128, t, s, s, c), (3, 3, c, mid), True, n),
                  ("temporal", (128, t, s, s, mid), (3, mid, c), True, 2 * n)]
    return units


def check_conv(torch, F, conv_bn):
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for kind, xs, ws, affine, copies in _conv_units():
        x = torch.randn(*xs, device="cuda", generator=g).to(torch.bfloat16)
        k = math.prod(ws[:-1])
        w = (torch.rand(*ws, device="cuda", generator=g) * 2 - 1) / math.sqrt(k)
        a = (None, None)
        if affine:
            a = (torch.rand(xs[-1], device="cuda", generator=g) + 0.5,
                 torch.randn(xs[-1], device="cuda", generator=g) * 0.1)
        y, s1, s2 = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)
        y0, s10, s20 = conv_bn.conv_unit_reference(x, w, *a, kind=kind)
        dy = (y.float() - y0.float()).abs()
        y0a = y0.float().abs()
        ok_y = bool((dy <= CONV_Y_REL * y0a + CONV_Y_ABS * y0a.max()).all())
        err = dy.max().item()
        what = f"conv unit {kind} {xs} affine={affine}"
        require(ok_y, f"{what}: max |dy| {err}")
        del dy, y0a
        s1_ratio = check_sums(what, y, y0, s1, s2, s10, s20)
        ms = timed(torch, lambda: conv_bn.conv_unit_fwd(x, w, *a, kind=kind))
        plain = timed(torch, lambda: conv_bn.conv_unit_reference(x, w, *a, kind=kind))
        xhat = torch.clamp_min(x * a[0].to(x.dtype) + a[1].to(x.dtype), 0) \
            if affine else x
        kern, pad = conv_bn._torch_kernel(w.to(x.dtype), kind)
        kern = kern.contiguous(memory_format=torch.channels_last_3d)

        def library():
            yl = F.conv3d(xhat.permute(0, 4, 1, 2, 3), kern, padding=pad)
            yf = yl.float()
            return yf.sum((0, 2, 3, 4)), (yf * yf).sum((0, 2, 3, 4))
        lib = timed(torch, library)
        m = math.prod(xs[:-1])
        flops = 2 * m * k * ws[-1]
        nbytes = x.numel() * 2 + w.numel() * 2 + m * ws[-1] * 2 \
            + (2 * xs[-1] * 4 if affine else 0) + 2 * ws[-1] * 4
        b_ms, _ = bound(nbytes, flops, PEAK_BF16)
        emit({"phase": "kernel_conv_unit", "kind": kind, "x": list(xs),
              "w": list(ws), "affine": affine, "per_forward": copies,
              "max_abs_err": err, "s1_err_over_limit": s1_ratio,
              "ms": ms, "plain_ms": plain, "library_ms_conv3d_sums": lib,
              "bound_ms": b_ms, "tflops": flops / ms / 1e9})
        acc = out.setdefault(kind, {"name": f"conv_unit_{kind}", "max_abs_err": 0.0,
                                    "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                    "library_ms": 0.0, "_ops": 0.0, "_bytes": 0.0})
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("_ops", flops / PEAK_BF16 * 1e3), ("_bytes", nbytes / HBM * 1e3)):
            acc[key] += copies * v
        del x, y, y0
    for acc in out.values():
        t_ops, t_bytes = acc.pop("_ops"), acc.pop("_bytes")
        acc["bound_ms"] = max(t_ops, t_bytes)
        acc["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return [out["spatial"], out["temporal"]]


def check_edges(torch, melspec, gru, conv_bn, cfg):
    """Shapes off the main path's tiling, for the kernels' masked edges:
    conv tiles with a partial row tile and masked output channels, a GRU
    batch tile half full with H not a multiple of 32, and mel rows long
    enough for two frame blocks, the second partial."""
    g = torch.Generator(device="cuda").manual_seed(5)
    errs = {}
    for kind, xs, ws in (("spatial", (3, 5, 7, 9, 24), (3, 3, 24, 40)),
                         ("temporal", (2, 7, 5, 3, 40), (3, 40, 24))):
        x = torch.randn(*xs, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(*ws, device="cuda", generator=g) * 0.1
        a = (torch.rand(xs[-1], device="cuda", generator=g) + 0.5,
             torch.randn(xs[-1], device="cuda", generator=g) * 0.1)
        y, s1, s2 = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)
        y0, s10, s20 = conv_bn.conv_unit_reference(x, w, *a, kind=kind)
        y0a = y0.float().abs()
        dy = (y.float() - y0.float()).abs()
        what = f"conv unit {kind} at edge shape {xs}"
        require(bool((dy <= CONV_Y_REL * y0a + CONV_Y_ABS * y0a.max()).all()),
                f"{what}: max |dy| {dy.max().item()}")
        errs[f"conv_{kind}"] = dy.max().item()
        errs[f"conv_{kind}_s1_err_over_limit"] = check_sums(
            what, y, y0, s1, s2, s10, s20)
    xp = torch.randn(5, 9, 2, 3 * 72, device="cuda", generator=g)
    w = torch.randn(2, 72, 3 * 72, device="cuda", generator=g) / math.sqrt(72)
    b = torch.randn(2, 3 * 72, device="cuda", generator=g) * 0.1
    errs["gru"] = (gru.gru_scan(xp, w, b)
                   - gru.gru_scan_reference(xp, w, b)).abs().max().item()
    require(errs["gru"] <= GRU_ATOL_F32, f"gru at edge shape: {errs['gru']}")
    wav = torch.randn(3, 16000, device="cuda", generator=g) * 0.3
    errs["melspec"] = (melspec.log_mel_spectrogram(wav, cfg)
                       - melspec.log_mel_spectrogram_reference(wav, cfg)
                       ).abs().max().item()
    require(errs["melspec"] <= MEL_ATOL, f"mel at edge shape: {errs['melspec']}")
    emit({"phase": "kernel_edge_shapes", "max_abs_err": errs})


def synthetic_video(np, n, fps, seed):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, 112, 112, 3), dtype=np.uint8)
    wav = (rng.randn(int(round(n / fps * 16000)) + 16000) * 0.1).astype(np.float32)
    return frames, wav


def serve(torch, np, cuda_lib, p, frames, wav, fps=None):
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = p.predict_video(frames=frames, waveform=wav, fps=fps)["pred"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    require(pred.shape == (len(frames), 2), f"pred shape {pred.shape}")
    require(bool(np.isfinite(pred).all()), "non-finite predictions")
    require(bool((np.abs(pred) <= 1.0).all()), "predictions outside [-1, 1]")
    missing = [k for k, v in counts.items() if v == 0]
    require(not missing, f"kernels not launched on the main path: {missing}")
    return pred, counts, dt


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from m3f_torch.ops import conv_bn, cuda_lib, gru, melspec
        from m3f_torch.config import MelConfig
        from m3f_torch.infer import Predictor
    except ImportError as e:
        print(f"chip_smoke: the m3f_torch package is not next to this file "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_lib.build()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0})

    # 2. each kernel against its plain version at the main path's shapes
    kernels = [check_mel(torch, melspec, MelConfig()), check_gru(torch, gru)]
    kernels += check_conv(torch, F, conv_bn)
    check_edges(torch, melspec, gru, conv_bn, MelConfig())
    torch.cuda.empty_cache()

    # 3. the serving path at full width
    p = Predictor(preset="longseq_eval")
    frames, wav = synthetic_video(np, 1024, 30.0, seed=0)
    torch.cuda.reset_peak_memory_stats()
    p.predict_video(frames=frames, waveform=wav)          # warm run
    pred30, counts30, dt = serve(torch, np, cuda_lib, p, frames, wav)
    want = {"melspec": 1, "gru": p.cfg.model.gru.num_layers,
            "conv_spatial": 10, "conv_temporal": 10}
    require(counts30 == want, f"launches {counts30}, expected {want}")
    emit({"phase": "serve_30fps", "frames": 1024, "launches": counts30,
          "s": dt, "frames_per_s": 1024 / dt,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    frames25, wav25 = synthetic_video(np, 1024, 25.0, seed=1)
    _, counts25, dt25 = serve(torch, np, cuda_lib, p, frames25, wav25, fps=25.0)
    emit({"phase": "serve_25fps", "frames": 1024, "launches": counts25,
          "s": dt25, "frames_per_s": 1024 / dt25})
    pc = Predictor(preset="longseq_eval",
                   overrides={"window.eval_max_windows": 64})
    pc.model.load_state_dict(p.model.state_dict())
    pred_c, counts_c, dtc = serve(torch, np, cuda_lib, pc, frames, wav)
    diff_c = float(np.abs(pred_c - pred30).max())
    require(diff_c <= CHUNK_ATOL, f"chunked vs fused eval differ by {diff_c}")
    emit({"phase": "serve_chunked", "frames": 1024, "launches": counts_c,
          "s": dtc, "frames_per_s": 1024 / dtc,
          "max_abs_diff_vs_fused": diff_c, "tol": CHUNK_ATOL})
    del p, pc
    torch.cuda.empty_cache()

    # 4. whole-path parity: one narrow model, CPU plain versions vs kernels
    overrides = {"model.visual.block_channels": [32, 64, 128, 256],
                 "model.visual.stem_channels": 32,
                 "model.visual.feature_dim": 256,
                 "model.audio.channels": [8, 16, 32, 64],
                 "model.audio.feature_dim": 64,
                 "model.gru.hidden_size": 64,
                 "window.windows_per_clip": 2,
                 "data.image_size": 32}
    p_cpu = Predictor(preset="longseq_eval", overrides=overrides, device="cpu")
    p_gpu = Predictor(preset="longseq_eval", overrides=overrides)
    p_gpu.model.load_state_dict(p_cpu.model.state_dict())
    rng = np.random.RandomState(4)
    results = {}
    for fps, n in ((None, 96), (25.0, 80)):
        f = rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8)
        w = (rng.randn(int(round(n / (fps or 30.0) * 16000)) + 16000) * 0.1
             ).astype(np.float32)
        a = p_cpu.predict_video(frames=f, waveform=w, fps=fps)["pred"]
        cuda_lib.reset_launches()
        b = p_gpu.predict_video(frames=f, waveform=w, fps=fps)["pred"]
        require(all(cuda_lib.launches.values()),
                f"narrow card run skipped a kernel: {cuda_lib.launches}")
        d = np.abs(a - b)
        require(d.max() <= PATH_ATOL and d.mean() <= PATH_MEAN_ATOL,
                f"card vs CPU preds at fps={fps}: max {d.max()}, mean {d.mean()}")
        results[str(fps or 30.0)] = {"max_abs_diff": float(d.max()),
                                     "mean_abs_diff": float(d.mean())}
    emit({"phase": "path_parity_cpu_vs_card", "frames": [96, 80],
          "results": results, "tol_max": PATH_ATOL, "tol_mean": PATH_MEAN_ATOL})

    # 5. the kernels line, the card line, the result line
    replaces = {"melspec": "m3f/pytorch_tpu/ops/pallas/melspec_pallas.py:88",
                "gru": "m3f/pytorch_tpu/ops/pallas/gru_pallas.py:61",
                "conv_unit_spatial": "m3f/pytorch_tpu/ops/pallas/conv_bn.py:172",
                "conv_unit_temporal": "m3f/pytorch_tpu/ops/pallas/conv_bn.py:217"}
    counter = {"melspec": "melspec", "gru": "gru",
               "conv_unit_spatial": "conv_spatial",
               "conv_unit_temporal": "conv_temporal"}
    source = {"melspec": "m3f_torch/csrc/melspec.cu", "gru": "m3f_torch/csrc/gru.cu",
              "conv_unit_spatial": "m3f_torch/csrc/conv_bn.cu",
              "conv_unit_temporal": "m3f_torch/csrc/conv_bn.cu"}
    line = []
    for k in kernels:
        name = k["name"]
        line.append({"name": name, "route": "cuda", "source": source[name],
                     "replaces": replaces[name],
                     "launches": counts30[counter[name]],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    print(smi)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
