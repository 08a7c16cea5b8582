"""njode_tpu_torch/card_checks.py with its check table patched to trivial
commands (the real checks need the card): ``--only`` merges and keeps the
other entries' stamps, a failing check makes the exit code nonzero, the
last-line rule of chip_smoke, the commit stamp, and the refusal without a
CUDA card."""

import json
import sys

import pytest
import torch

from njode_tpu_torch import card_checks as cc


def _cmd(code):
    return (sys.executable, "-c", code)


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(cc, "require_card", lambda: None)
    monkeypatch.setattr(cc, "card_line", lambda: "Fake H100, 700.00 W")
    table = {"a": cc.Check(_cmd("print('a')"), 60),
             "b": cc.Check(_cmd("print('x'); print('{\"ok\": true}')"), 60,
                           cc._last_line_ok),
             "c": cc.Check(_cmd("import os; print(os.environ.get('R'))"),
                           60, lambda rc, out: out.strip() == "3",
                           (("R", "3"),))}
    monkeypatch.setattr(cc, "CHECKS", table)
    return table


def test_whole_run_then_only_merges_and_keeps_stamps(fake, tmp_path,
                                                     monkeypatch):
    out = str(tmp_path / "checks.json")
    assert cc.main(["--out", out, "--fast"]) == 0
    first = json.load(open(out))["checks"]
    assert set(first) == {"a", "b", "c"} and all(
        first[k]["ok"] for k in first)
    for k in first:
        assert first[k]["card"] == "Fake H100, 700.00 W"
        assert first[k]["commit"] and first[k]["commit_kind"]
        assert (tmp_path / "checks_logs" / f"{k}.log").exists()
    monkeypatch.setattr(cc, "commit_stamp", lambda: ("newcommit", "test"))
    monkeypatch.setitem(fake, "a", cc.Check(_cmd("print('again')"), 60))
    assert cc.main(["--out", out, "--only", "a"]) == 0
    second = json.load(open(out))
    assert second["ok"] and second["checks"]["a"]["commit"] == "newcommit"
    assert "again" in second["checks"]["a"]["tail"]
    for k in ("b", "c"):
        assert second["checks"][k] == first[k]


def test_a_failing_check_gives_a_nonzero_exit(fake, tmp_path, monkeypatch):
    out = str(tmp_path / "checks.json")
    monkeypatch.setitem(fake, "b", cc.Check(
        _cmd("print('{\"ok\": true}'); import sys; sys.exit(3)"), 60,
        cc._last_line_ok))
    monkeypatch.setitem(fake, "t", cc.Check(
        _cmd("import time; time.sleep(30)"), 0.5))
    assert cc.main(["--out", out]) == 1
    res = json.load(open(out))
    assert not res["ok"] and res["checks"]["a"]["ok"]
    assert res["checks"]["b"]["returncode"] == 3 and not res["checks"]["b"][
        "ok"]
    assert "timeout" in res["checks"]["t"]["error"]
    # without --fast the fast-only environment is not set
    assert not res["checks"]["c"]["ok"]
    # an earlier failure stays in the file: an --only run of a passing
    # check still exits nonzero
    assert cc.main(["--out", out, "--only", "a"]) == 1


@pytest.mark.parametrize("line,rc,ok", [
    ('{"ok": true, "device": {"platform": "gpu"}}', 0, True),
    ('{"ok": true}', 1, False), ('{"ok": false}', 0, False),
    ("done", 0, False), ("", 0, False)])
def test_chip_smoke_passes_only_on_its_last_line(line, rc, ok):
    assert cc._last_line_ok(rc, "[phase] x=1\n" + line + "\n") is ok


_BENCH_LINE = json.dumps({
    "metric": "train_throughput_paths_per_sec_per_chip", "value": 33105.2,
    "unit": "paths/sec/chip", "vs_baseline": 165.53,
    "flops_per_path": 11462400, "device_tflops": 0.254, "mfu_pct": 0.379})


@pytest.mark.parametrize("line,rc,ok", [
    (_BENCH_LINE, 0, True),
    ('{}', 0, False),
    ('{"vs_baseline": 0.005}', 0, False),
    (_BENCH_LINE.replace('"mfu_pct"', '"mfu"'), 0, False),
    (_BENCH_LINE, 1, False),
    (_BENCH_LINE.replace("165.53", "19.99"), 0, False),
    ("no json", 0, False)])
def test_bench_passes_only_on_the_jax_criterion(line, rc, ok):
    out = "NVIDIA H100 80GB HBM3, 700.00 W\n" + line + "\n"
    assert cc._bench_line_ok(rc, out) is ok
    assert cc.CHECKS["bench"].ok is cc._bench_line_ok


def test_commit_stamp_without_git(monkeypatch, tmp_path):
    commit, kind = cc.commit_stamp()
    assert commit and kind
    monkeypatch.setattr(cc, "REPO", str(tmp_path))
    (tmp_path / "chip_smoke.py").write_text("print(1)\n")
    commit, kind = cc.commit_stamp()
    assert commit.startswith("sha256:") and "no git" in kind


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        cc.main(["--only", "entry"])


def test_the_table_covers_every_card_check():
    assert list(cc.CHECKS) == ["chip_smoke", "card_tests", "bench", "entry",
                               "dryrun"]
    argv = cc.CHECKS["card_tests"].argv
    assert "--noconftest" in argv and all(f in argv for f in (
        "tests/test_torch_fused_scan_card.py",
        "tests/test_torch_fused_gob_card.py",
        "tests/test_torch_fused_scan_members_card.py"))
    assert cc.CHECKS["chip_smoke"].argv == (sys.executable, "chip_smoke.py")
