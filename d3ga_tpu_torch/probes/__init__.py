"""Card probes: the port of the JAX package's TPU probes under `tools/`.

- `mxu.py` (P1, tools/mxu_probe.py): matmul rates at the blend's and the
  compaction's shapes in FP32 SIMT, TF32 and 3xTF32 (`wgmma`), and a roll
  + select chain (`csrc/probes_mxu.cu`);
- `widerow.py` (P2, tools/widerow_probe.py): a passthrough over narrow and
  wide rows of the same bytes (`csrc/probes_widerow.cu`), row gathers and
  searches in PyTorch ops;
- `fused_bisect.py` (P3, tools/fused_bisect.py): K9's forward cut at four
  stages (the CUT parameter of `csrc/fused.cu::fused_fwd_kernel`, whose
  whole build is K9's forward; the design before's cuts stay as the
  baseline) and its backward's two kernels timed apart;
- `profiler_drops.py`: a bisect of the settings under which torch.profiler
  drops whole calls (not a kernel probe).

Each module has hand-written kernels with plain PyTorch versions beside
them (the plain version runs for CPU tensors only; a CUDA tensor launches
the kernel or raises), launch counters, its case list, `run(device, ...)`
returning JSON rows, and a CLI (`python3 -m d3ga_tpu_torch.probes.mxu`)
that runs the full case list on the card.

The loop probes time as the TPU tools did, by slope: one launch of n trips
of UNROLL data-dependent ops at two trip counts n1 < n2, per op =
(t(n2) - t(n1)) / ((n2 - n1) UNROLL), which cancels the launch's own
cost. Trip counts are picked per case so the longer launch takes about
`target_ms`. Single kernels are timed by CUDA events around launches
queued behind a spin (`queued_ms`), kernels apart by torch.profiler
(`profiled`, `device_ms`, which `chip_smoke.py` uses too, with the card's
peak rates and the bound helpers below). A profile that records fewer
calls than it ran is kept in `SHORT_PROFILES` and handed to
`on_short_profile` (chip_smoke.py prints it on its own line).
"""

import json
import os
import time

import torch

from d3ga_tpu_torch.bench_stages import card, time_ms

UNROLL = 8
REPS = 3  # timed launches at each trip count; the best is kept

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# 3.35 TB/s, FP32 67 TFLOP/s, TF32 tensor cores 495 TFLOP/s; 132 SMs at a
# 1.98 GHz boost clock, 128 FP32 lanes an SM (one instruction a lane a
# clock: half the FP32 FLOP rate, which counts an FMA as two); the
# special-function unit 16 results a clock an SM (Hopper white paper)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
SMS = 132
FP32_INSTR_PER_S_PER_SM = 128 * 1.98e9
SFU_OPS_PER_S = 16 * SMS * 1.98e9
# K8/K9's polynomial walk (coeff_walk.cuh) at C colours, FMAs counted as
# two operations, as the FP32 peak counts them.
COEFF_BWD_SFU_PER_PAIR = 2  # exp and the division of the one counted walk


def coeff_fwd_ops(C):
    """Forward FP32 operations a pair: the falloff polynomial (5 FMAs),
    opacity * exp, the 0.99 clamp, T * (1 - alpha), w = alpha T (15), and
    the C colour FMAs."""
    return 15 + 2 * C


def coeff_bwd_ops(C):
    """Backward FP32 operations a pair, for one walk (the first walk, which
    finds T_bg, is not counted, so this stays a lower bound): the
    forward's 15, dw (C FMAs), the suffix R -= dw w (2), dlg (1), dalpha
    (3), dpower and its five basis products (6), dopacity (1), the C
    colour cotangents, and one add for each of the 7 + C per-record sums."""
    return 35 + 4 * C


# a visited pair that the walk does not use (power > 0, or raw < 1/255)
# costs only the polynomial (5 FMAs as two) and its test, and the exp that
# decides raw >= 1/255 (needed wherever power <= 0; charged to every
# unused pair, as chip_smoke.py's blend_bound charges K2's and K3's)
COEFF_TEST_FP32_OPS_PER_PAIR = 11
COEFF_TEST_SFU_PER_PAIR = 1


def coeff_bound(bytes_, used, unused, fp32_per_used, sfu_per_used):
    """`bound` for a polynomial walk (K8, K9) whose `used` pairs (power
    <= 0 and raw >= 1/255) cost fp32_per_used FP32 operations and
    sfu_per_used special-function results, and whose `unused` visited
    pairs cost the test's (COEFF_TEST_*). Returns (bound ms, "bytes" or
    "operations", both times in s)."""
    times = {"bytes": bytes_ / HBM_BYTES_PER_S,
             "operations": max(
                 (used * fp32_per_used + unused * COEFF_TEST_FP32_OPS_PER_PAIR) / FP32_OPS_PER_S,
                 (used * sfu_per_used + unused * COEFF_TEST_SFU_PER_PAIR) / SFU_OPS_PER_S)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, times


def bound(bytes_, pairs, fp32_per_pair, sfu_per_pair):
    """(bound ms, "bytes" or "operations") for a walk of `pairs`
    (pixel, slot) pairs that must move `bytes_`."""
    times = {"bytes": bytes_ / HBM_BYTES_PER_S,
             "operations": max(pairs * fp32_per_pair / FP32_OPS_PER_S,
                               pairs * sfu_per_pair / SFU_OPS_PER_S)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def slope(launch, device, target_ms=20.0, trips=None):
    """Per-op time of `launch(n)` (one launch of n trips of UNROLL ops):
    {"trips": [n1, n2], "ms": [t(n1), t(n2)] (best of REPS), "ns_per_op"}.
    trips=None picks n2 so that t(n2) is about target_ms, n1 = n2 // 4."""
    device = torch.device(device)
    if trips is None:
        t = min(time_ms(lambda: launch(1), 1, device, warmup=1) for _ in range(REPS))
        n2 = int(min(max(target_ms / max(t, 1e-3), 4), 1 << 16))
        trips = (max(1, n2 // 4), n2)
    n1, n2 = trips
    ms = [min(time_ms(lambda: launch(n), 1, device, warmup=1) for _ in range(REPS))
          for n in (n1, n2)]
    return {"trips": [n1, n2], "ms": ms,
            "ns_per_op": (ms[1] - ms[0]) * 1e6 / ((n2 - n1) * UNROLL)}


# the kernel torch.cuda._sleep launches: `profiled` follows each call with
# one, so a profile counts the calls whose kernels it recorded
MARKER = "spin_kernel"
QUEUE_SPIN_CYCLES = 20_000_000  # ~10 ms at the 1.98 GHz boost: `queued_ms`'s head start
PROFILE_ATTEMPTS = 5  # profiles `profiled` takes at most to record every call
# host ms `profiled` waits between a profile's warm-up and its first timed
# call: the profiler has lost calls at the start of its window, their
# host events with their kernels (`profiler_drops.py`)
PROFILE_LEAD_MS = 10.0
# the marker cycles a call index of `profiled` (call i's marker spins 1 +
# PROFILE_TAG (i + 1) cycles), which tell the lost calls apart (`lost_calls`)
PROFILE_TAG = 20000


def device_events(prof, DeviceType):
    """A profile's kernels: device events, less the ranges that
    record_function annotations (e.g. Optimizer.step) mirror onto the
    device timeline, which would count their kernels twice, and less the
    call markers of `profiled`."""
    return [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and MARKER not in e.key
    ]


def recorded_calls(prof, DeviceType):
    """How many of `profiled`'s calls the profile recorded: its markers."""
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and MARKER in e.key)


def per_call(event, calls):
    """(ms, launches) a call of one profiled kernel: the mean of its
    recorded launches times its launches a call, rounded from how many the
    `calls` recorded calls hold (robust to a drop window that cuts a call)."""
    n = round(event.count / calls)
    return event.self_device_time_total / event.count / 1e3 * n, n


# the profiles `profiled` kept that recorded fewer calls than they ran:
# {"where": its caller outside this module, "calls", "recorded",
# "attempts", "lost": each attempt's lost call indices}; each is also
# passed to on_short_profile where it is set
SHORT_PROFILES = []
on_short_profile = None


def profile_once(fn, calls, device, schedule_steps=True, cpu=True, tag=0, lead_ms=0.0):
    """One torch.profiler profile (CUDA activity, and CPU activity with
    `cpu`) of a warm-up call and `calls` calls of fn, call i followed by a
    marker kernel of 1 + tag (i + 1) cycles (tag > 0 tells the calls
    apart by their markers' durations). With `schedule_steps` the window
    is a profiler schedule (warm-up 1, active `calls`) stepped after each
    call; else one plain `profile()` block, each timed call in a
    `record_function("call#<i>")` range. The host waits `lead_ms` between
    the warm-up and the first timed call. Returns (the profile, wall ms a
    call, the calls it recorded, by its markers)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    kw = dict(schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)) if schedule_steps else {}
    with profile(activities=acts, **kw) as prof:
        fn()
        torch.cuda.synchronize(device)
        if schedule_steps:
            prof.step()
        if lead_ms > 0:
            time.sleep(lead_ms / 1e3)
        t0 = time.perf_counter()
        for i in range(calls):
            if schedule_steps:
                fn()
                torch.cuda._sleep(1 + tag * (i + 1))
            else:
                with record_function(f"call#{i}"):
                    fn()
                    torch.cuda._sleep(1 + tag * (i + 1))
            if i == calls - 1:  # the last step closes the window: its kernels must be done
                torch.cuda.synchronize(device)
                wall = (time.perf_counter() - t0) * 1e3 / calls
            if schedule_steps:
                prof.step()
    return prof, wall, recorded_calls(prof, DeviceType)


def marker_durations(prof):
    """The device durations (us) of a profile's marker kernels, in order of
    their start."""
    from torch.autograd import DeviceType

    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA and MARKER in e.name]
    return [e.time_range.elapsed_us() for e in sorted(ev, key=lambda e: e.time_range.start)]


def lost_calls(durations, calls):
    """The indices of the calls whose markers a profile lacks, from the
    recorded markers' durations (call i's marker lasts i + 1 units, the
    `tag` of `profile_once`): each choice of one missing index is fitted,
    and failing that the durations are read in units of their median
    step."""
    import numpy as np

    d = np.asarray(durations, float)
    if len(d) >= calls or len(d) == 0:
        return [] if len(d) >= calls else list(range(calls))
    if len(d) == calls - 1:
        fits = []
        for k in range(calls):
            e = np.array([i + 1 for i in range(calls) if i != k], float)
            fits.append((float(((d - d.dot(e) / e.dot(e) * e) ** 2).sum()), k))
        return [min(fits)[1]]
    u = np.median(np.diff(np.sort(d))) if len(d) > 1 else d[0]
    seen = {int(round(x / u)) - 1 for x in d}
    return sorted(set(range(calls)) - seen)


def _caller():
    """file:line of the nearest frame outside this module."""
    import traceback

    for fr in reversed(traceback.extract_stack()[:-1]):
        if fr.filename != __file__:
            return f"{os.path.basename(fr.filename)}:{fr.lineno}"
    return "?"


def profiled(fn, calls, device):
    """torch.profiler (CPU and CUDA activity, `profile_once`) over `calls`
    calls of fn, after an unprofiled call and a warm-up call inside the
    profiler and PROFILE_LEAD_MS of host time, each call followed by a
    marker kernel (tagged: PROFILE_TAG). A profile does not always record
    every launch (it has dropped whole calls' kernels and host events, in
    windows, and once every call; always the window's first calls, more
    of them late in a long process: `profiler_drops.py`), so it is taken
    again, up to PROFILE_ATTEMPTS times, until its markers count every
    call. Returns (the profile, wall ms a call, the calls it recorded) of
    the attempt that recorded the most calls, and the calls each attempt
    recorded; None off the card. Where even that one recorded
    fewer than `calls`, it is kept in SHORT_PROFILES with each attempt's
    lost call indices (`lost_calls`), and passed to on_short_profile."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    best, attempts, lost = None, [], []
    for _ in range(PROFILE_ATTEMPTS):
        run = profile_once(fn, calls, device, tag=PROFILE_TAG, lead_ms=PROFILE_LEAD_MS)
        attempts.append(run[2])
        lost.append(lost_calls(marker_durations(run[0]), calls) if run[2] < calls else [])
        if best is None or run[2] > best[2]:
            best = run
        if run[2] == calls:
            break
    if best[2] < calls:
        short = {"where": _caller(), "calls": calls, "recorded": best[2], "attempts": attempts,
                 "lost": lost}
        SHORT_PROFILES.append(short)
        if on_short_profile is not None:
            on_short_profile(short)
    return (*best, attempts)


def queued_ms(fn, iters, device):
    """Device ms a call of fn whose kernels are cheap to launch: CUDA events
    around `iters` calls queued behind a spin of QUEUE_SPIN_CYCLES, so they
    run back to back and the host's launch cost stays hidden while the
    host queues them faster than the spin ends (None where it did not);
    the host clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return time_ms(fn, iters, device)
    fn()
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event(enable_timing=True)
    spin.record()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters if queued < spin.elapsed_time(a) else None


def device_ms(fn, iters, device, names=()):
    """Device time of `fn`'s kernels over `iters` profiled calls
    (`profiled`): {"total": a call's (`per_call` of each kernel), "calls":
    how many calls were recorded, "attempts": the calls each profile
    taken recorded, name: {"ms": the mean duration
    of one launch of the kernels whose name holds it, "launches": how many
    were recorded}, for each of `names`}; None off the card or where the
    profiler records no call."""
    run = profiled(fn, iters, device)
    if run is None:
        return None
    from torch.autograd import DeviceType

    calls = run[2]
    if calls == 0:
        return None
    total, us, n = 0.0, dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in device_events(run[0], DeviceType):
        total += per_call(e, calls)[0]
        for name in names:
            if name in e.key:
                us[name] += e.self_device_time_total
                n[name] += e.count
    if total <= 0:
        return None
    out = {"total": total, "calls": calls, "attempts": run[3]}
    out.update({k: {"ms": us[k] / 1e3 / n[k] if n[k] else None, "launches": n[k]} for k in names})
    return out


def emit(probe, device, rows):
    """Prints and returns one probe's JSON line: {"probe", "device", "card"
    (nvidia-smi's name and power limit; None on the CPU), "rows"}."""
    on_card = torch.device(device).type == "cuda"
    line = {"probe": probe, "device": device_name(device), "card": card() if on_card else None,
            "rows": rows}
    print(json.dumps(line), flush=True)
    return line


def reset_launches():
    """Every probe kernel's launch counter to 0."""
    from d3ga_tpu_torch.probes import fused_bisect, mxu, widerow

    for counts in (mxu.launches, mxu.v1_launches, mxu.roll_design_launches,
                   fused_bisect.launches, fused_bisect.v1_launches):
        for k in counts:
            counts[k] = 0
    widerow.launches = widerow.v1_launches = 0


def cli_device(name):
    """The device a probe CLI runs on; the card unless asked for the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to rehearse on the CPU)")
    return torch.device(name)
