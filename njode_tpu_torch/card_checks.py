"""Every check that needs the CUDA card, in one command, the port's
counterpart of the repo's ``tpu_checks.py``:

    python -m njode_tpu_torch.card_checks [--only a,b] [--fast] [--out PATH]

Each check runs in a process of its own, from the root of the checkout,
with its own time limit:

- ``chip_smoke``: ``chip_smoke.py`` (under this interpreter, as every
  check runs), which passes only with exit code 0 and ``{"ok": true,
  ...}`` as its last line;
- ``card_tests``: ``pytest --noconftest`` over every ``tests/test_torch_*_
  card.py`` (the kernels against their plain versions at many shapes);
- ``bench``: ``python -m njode_tpu_torch.bench`` (3 timed epochs each way
  under ``--fast``, else its default 7);
- ``entry``: ``python -m njode_tpu_torch.entry``, the flagship's loss;
- ``dryrun``: ``python -m njode_tpu_torch.entry dryrun 2``.

It writes one JSON file, ``results/card_checks.json`` (``--fast``:
``results/card_checks_fast.json``), and each check's whole output beside it
(``<file>_logs/<check>.log``). Each entry holds ``ok``, ``seconds``, the
output's tail, the time it ran, the commit (``git describe --always
--dirty``; in a copy without ``.git``, a sha256 of the port's sources,
``commit_kind`` saying which) and the card's name and power limit.
``--only`` runs those checks and merges them into the file: the other
entries keep their own stamps. The exit code is 1 where any entry of the
file failed. Without a CUDA card it raises at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Callable

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_FILE = os.path.join(REPO, "results", "card_checks.json")
FAST_RESULT_FILE = os.path.join(REPO, "results", "card_checks_fast.json")
TAIL_CHARS = 2000


def _rc_ok(rc, stdout):
    return rc == 0


def _last_line_ok(rc, stdout):
    """Exit code 0 and ``{"ok": true, ...}`` as the last line."""
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    try:
        return rc == 0 and json.loads(lines[-1]).get("ok") is True
    except (IndexError, ValueError, AttributeError):
        return False


# the bench's criterion, as tpu_checks.py holds the JAX bench: the 20x
# target over BASELINE.json and the fields that show a regression as a
# shift of the FLOP rate
BENCH_MIN_VS_BASELINE = 20.0
BENCH_KEYS = ("flops_per_path", "device_tflops", "mfu_pct")


def _bench_line_ok(rc, stdout):
    """Exit code 0 and the bench's JSON line (the last JSON object among
    the lines) with ``vs_baseline >= BENCH_MIN_VS_BASELINE`` and every key
    of ``BENCH_KEYS``."""
    res = None
    for ln in stdout.splitlines():
        ln = ln.strip()
        if not ln.startswith("{"):
            continue
        try:
            obj = json.loads(ln)
        except ValueError:
            continue
        if isinstance(obj, dict):
            res = obj
    if rc != 0 or res is None:
        return False
    vs = res.get("vs_baseline")
    return (isinstance(vs, (int, float)) and vs >= BENCH_MIN_VS_BASELINE
            and all(k in res for k in BENCH_KEYS))


@dataclasses.dataclass(frozen=True)
class Check:
    argv: tuple                 # run from the root of the checkout
    timeout: float              # seconds
    ok: Callable = _rc_ok       # (exit code, stdout) -> passed
    fast_env: tuple = ()        # (name, value) pairs set under --fast


def _card_test_files():
    return tuple(sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "tests", "test_torch_*_card.py"))))


# chip_smoke first: it builds the kernels as a fresh checkout does (its
# time is the one the checkout's users see); the others load them
CHECKS = {
    "chip_smoke": Check((sys.executable, "chip_smoke.py"), 1500,
                        _last_line_ok),
    "card_tests": Check((sys.executable, "-m", "pytest", "--noconftest",
                         "-p", "no:cacheprovider", "-q",
                         *_card_test_files()), 1800),
    "bench": Check((sys.executable, "-m", "njode_tpu_torch.bench"), 900,
                   _bench_line_ok, (("NJODE_BENCH_REPS", "3"),)),
    "entry": Check((sys.executable, "-m", "njode_tpu_torch.entry"), 600),
    "dryrun": Check((sys.executable, "-m", "njode_tpu_torch.entry",
                     "dryrun", "2"), 900),
}


def require_card():
    if not torch.cuda.is_available():
        raise RuntimeError("card_checks needs a CUDA card "
                           "(torch.cuda.is_available() is False)")


def card_line():
    from njode_tpu_torch.bench import card_line as line
    return line()


def _source_digest():
    """sha256 over the port's sources, the card tests and chip_smoke.py
    (each file's path and bytes, in sorted order)."""
    pats = ("njode_tpu_torch/**/*.py", "njode_tpu_torch/**/*.cu",
            "njode_tpu_torch/**/*.cuh", "njode_tpu_torch/**/*.cc",
            "tests/test_torch_*_card.py", "chip_smoke.py")
    files = sorted({os.path.relpath(p, REPO) for pat in pats
                    for p in glob.glob(os.path.join(REPO, pat),
                                       recursive=True)})
    h = hashlib.sha256()
    for rel in files:
        h.update(rel.encode() + b"\0")
        with open(os.path.join(REPO, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def commit_stamp():
    """``(commit, kind)``: ``git describe --always --dirty``, or where the
    checkout has no git metadata the sha256 of the port's sources."""
    if os.path.exists(os.path.join(REPO, ".git")):
        try:
            res = subprocess.run(["git", "describe", "--always", "--dirty"],
                                 capture_output=True, text=True, cwd=REPO,
                                 timeout=30)
            if res.returncode == 0 and res.stdout.strip():
                return res.stdout.strip(), "git describe --always --dirty"
        except (OSError, subprocess.SubprocessError):
            pass
    return ("sha256:" + _source_digest(),
            "sha256 of the port's sources, the card tests and chip_smoke.py"
            " (this copy has no git metadata)")


def run_check(name, check, fast, log_dir):
    """Run one check; its entry (without the stamps)."""
    env = dict(os.environ)
    if fast:
        env.update(dict(check.fast_env))
    t0 = time.time()
    try:
        proc = subprocess.run(list(check.argv), capture_output=True,
                              text=True, cwd=REPO, env=env,
                              timeout=check.timeout)
        out, err, rc = proc.stdout, proc.stderr, proc.returncode
        error = None
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else (
            e.stdout or "")
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else (
            e.stderr or "")
        rc, error = None, f"timeout after {check.timeout} s"
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, name + ".log"), "w") as f:
        f.write(f"$ {' '.join(check.argv)}\n{out}\n--- stderr ---\n{err}")
    res = {"ok": rc is not None and bool(check.ok(rc, out)),
           "returncode": rc, "seconds": round(time.time() - t0, 2),
           "tail": (out + ("\n--- stderr ---\n" + err if err else ""))[
               -TAIL_CHARS:]}
    if error:
        res["error"] = error
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="every check of the port that needs the CUDA card")
    ap.add_argument("--only", default=None,
                    help="comma-separated checks, merged into the file")
    ap.add_argument("--fast", action="store_true",
                    help="fewer timed repetitions; its own result file")
    ap.add_argument("--out", default=None, help="the JSON file to write")
    args = ap.parse_args(argv)
    require_card()
    selected = list(CHECKS) if args.only is None else [
        s for s in args.only.split(",") if s]
    unknown = [s for s in selected if s not in CHECKS]
    if unknown or not selected:
        raise SystemExit(f"unknown or no checks {unknown}; valid: "
                         f"{','.join(CHECKS)}")
    out = args.out or (FAST_RESULT_FILE if args.fast else RESULT_FILE)
    log_dir = os.path.splitext(out)[0] + "_logs"
    card = card_line()
    commit, kind = commit_stamp()
    results = {"checks": {}}
    if args.only is not None and os.path.exists(out):
        with open(out) as f:
            results["checks"] = json.load(f).get("checks", {})
    for name in selected:
        print(f"== {name} ==", flush=True)
        res = run_check(name, CHECKS[name], args.fast, log_dir)
        res.update(timestamp=time.strftime("%Y-%m-%dT%H:%M:%S"),
                   commit=commit, commit_kind=kind, card=card,
                   profile="fast" if args.fast else "full")
        results["checks"][name] = res
        print(json.dumps({k: v for k, v in res.items() if k != "tail"}),
              flush=True)
    results["ok"] = all(c.get("ok") for c in results["checks"].values())
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"card_checks_ok": results["ok"], "file": out}),
          flush=True)
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
