"""Does a ``torch.profiler`` capture lose the kernel records at its start,
and do launches that open the capture (as ``utils/profiling.trace`` does)
keep them? Needs a CUDA card:

    python scripts/cupti_capture_check.py

Eight rounds of 40 captures, each of 50 (or 400) one-element ``mul_``
launches, with CUDA activity alone or with the CPU's, plain, after a
0.1 s idle gap, or opened by 256 ``add_`` launches spread over 0.1 s; a
line per round: the captures that hold fewer ``mul_`` kernel records
than launches (``short``), the fewest held, the first eight counts."""
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

CUDA = [ProfilerActivity.CUDA]
BOTH = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def warm_up(y, n=256, spread_s=0.1):
    torch.cuda.synchronize()
    for _ in range(n):
        y.add_(0.0)
        time.sleep(spread_s / n)
    torch.cuda.synchronize()


def session(x, y, acts, n=50, warm=False, gap_s=0.0):
    with profile(activities=acts) as prof:
        if warm:
            warm_up(y)
        if gap_s:
            torch.cuda.synchronize()
            time.sleep(gap_s)
        for _ in range(n):
            x.mul_(1.0)
        torch.cuda.synchronize()
    got = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
              and "Mul" in e.name)
    return got


def main():
    x = torch.zeros(1, device="cuda")
    y = torch.ones(1, device="cuda")
    res = {}
    t0 = time.time()
    for tag, kw in (("cuda_plain", dict(acts=CUDA)),
                    ("both_plain", dict(acts=BOTH)),
                    ("both_gap", dict(acts=BOTH, gap_s=0.1)),
                    ("both_warm", dict(acts=BOTH, warm=True)),
                    ("cuda_plain2", dict(acts=CUDA)),
                    ("cuda_warm", dict(acts=CUDA, warm=True)),
                    ("both_plain2", dict(acts=BOTH, n=400)),
                    ("both_warm2", dict(acts=BOTH, warm=True, n=400))):
        counts = [session(x, y, **kw) for _ in range(40)]
        n = kw.get("n", 50)
        res[tag] = dict(short=sum(c < n for c in counts), min=min(counts),
                        first=counts[:8], t=round(time.time() - t0, 1))
        print(tag, json.dumps(res[tag]), flush=True)


if __name__ == "__main__":
    main()
