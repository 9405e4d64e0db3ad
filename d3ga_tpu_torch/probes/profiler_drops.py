"""Which settings make torch.profiler drop whole calls: a bisect on the card.

`probes.profiled` has seen profiles record fewer calls than they ran, the
lost calls' host events (ProfilerStep) gone with their kernels. In
chip_smoke.py every 20-call profile recorded 19 from its sharded phase
on (which starts a NCCL world of one), none before, and 3-call profiles
all of theirs. This runs, in one fresh process, in three phases (before
a NCCL world of one is started, while it is up, after it is destroyed),
each setting round by round so that each meets every count of profiles
taken before it:

- the window: a profiler schedule stepped after each call (`profiled`'s
  way), against one plain `profile()` block (`probes.profile_once`);
- CPU activity on or off;
- 10 or 20 calls a profile;
- the host waiting 0 or 10 ms between the window's opening and the
  first timed call (LEADS_MS);
- the function: `torch.mul` of a 16 M-float tensor, and K9's backward at
  `fused_bisect.make_inputs`' full shape (48 blocks x 4,096 candidates,
  K 256, C 6).

Call i is followed by a marker kernel of 1 + PROFILE_TAG (i + 1) cycles,
so the markers' durations tell which calls a profile lost
(`probes.lost_calls`); with CPU activity
the named host events (ProfilerStep, call#<i>) are counted too. Prints
one JSON line: every profile's settings, its phase and index in the
process, the calls it recorded on the device and the host and which it
lost, and summaries by phase and by setting.

    python3 -m d3ga_tpu_torch.probes.profiler_drops [--rounds 3]
"""

import argparse
import datetime
import itertools
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from d3ga_tpu_torch import probes
from d3ga_tpu_torch.probes import fused_bisect
from d3ga_tpu_torch.raster import fused

WINDOWS = {"schedule": True, "block": False}
CALLS = (10, 20)
LEADS_MS = (0.0, 10.0)  # host ms between the window's opening and the first timed call


def host_calls(prof, schedule_steps):
    """The named host events the profile holds on the CPU side (their
    mirrors on the device timeline are not counted): ProfilerStep ranges
    (the active steps) or call#<i> ranges."""
    from torch.autograd import DeviceType

    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    if schedule_steps:
        return sum(1 for e in host if e.name == "ProfilerStep*")
    return sum(1 for e in host if e.name.startswith("call#"))


def functions(device):
    """{name: fn} of the profiled functions, built on `device`."""
    x = torch.randn(1 << 24, device=device)
    vals, rects = (torch.from_numpy(a).to(device) for a in fused_bisect.make_inputs(48, 32, 6))
    g = torch.randn((48, fused.TB, fused.NPIX, 7), generator=torch.Generator(device=device)
                    .manual_seed(1), device=device)
    return {"torch.mul": lambda: torch.mul(x, 1.5),
            "k9_backward": lambda: fused.select_blend_bwd(vals, rects, g, 256, 6)}


def profiles(fns, device, phase, rounds, rows):
    settings = list(itertools.product(fns, WINDOWS, (True, False), CALLS, LEADS_MS))
    for rd in range(rounds):
        for name, window, cpu, calls, lead in settings:
            steps = WINDOWS[window]
            prof, wall, rec = probes.profile_once(fns[name], calls, device, steps, cpu,
                                                  tag=probes.PROFILE_TAG, lead_ms=lead)
            rows.append({
                "index": len(rows), "phase": phase, "round": rd, "fn": name, "window": window,
                "cpu": cpu, "calls": calls, "lead_ms": lead, "device_calls": rec,
                "lost": probes.lost_calls(probes.marker_durations(prof), calls),
                "host_calls": host_calls(prof, steps) if cpu else None, "wall_ms": wall})
            del prof


def summary(rows, key):
    out = {}
    for r in rows:
        s = out.setdefault(key(r), {"profiles": 0, "short": 0, "calls": 0, "device": 0,
                                    "host": 0, "host_counted": 0, "lost_at": {}})
        s["profiles"] += 1
        s["short"] += r["device_calls"] < r["calls"]
        s["calls"] += r["calls"]
        s["device"] += r["device_calls"]
        if r["host_calls"] is not None:
            s["host"] += r["host_calls"]
            s["host_counted"] += r["calls"]
        for i in r["lost"]:
            at = "last" if i == r["calls"] - 1 else str(i)
            s["lost_at"][at] = s["lost_at"].get(at, 0) + 1
    return out


def run(device, rounds):
    fns = functions(device)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize(device)
    rows, t0 = [], time.perf_counter()
    profiles(fns, device, "before NCCL", rounds, rows)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                                world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
        try:
            t = torch.ones(1, device=device)
            dist.all_reduce(t)
            torch.cuda.synchronize(device)
            profiles(fns, device, "NCCL up", rounds, rows)
        finally:
            dist.destroy_process_group()
    profiles(fns, device, "after NCCL", rounds, rows)
    return {"rows": rows, "seconds": time.perf_counter() - t0,
            "by_phase": summary(rows, lambda r: r["phase"]),
            "by_lead": {f"lead {k} ms": v
                        for k, v in summary(rows, lambda r: r["lead_ms"]).items()},
            "by_setting": {" | ".join(map(str, k)): v for k, v in summary(
                rows, lambda r: (r["phase"], r["window"], f"cpu {'on' if r['cpu'] else 'off'}",
                                 f"{r['calls']} calls", f"lead {r['lead_ms']} ms")).items()},
            "by_fn": {" | ".join(k): v for k, v in summary(
                rows, lambda r: (r["phase"], r["fn"])).items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profiler_drops: needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run(device, args.rounds)
    print(json.dumps({"probe": "profiler_drops", "device": probes.device_name(device),
                      "card": probes.card(), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
