"""A run writes only inside its checkout, HOME, XDG_CACHE_HOME and TMPDIR:
never to /dev/shm or a fixed /tmp path. The throwaway cell runs in a fresh
process whose audit hook records every file it opens for writing, creates,
moves or removes, and every program it starts."""

import json
import os
import subprocess
import sys

from benchmark import spec

TESTS = os.path.dirname(os.path.abspath(__file__))
CODE = r"""
import json, os, sys
log = []
def hook(event, args):
    if event == "open":
        path, mode, flags = args
        if isinstance(path, int) or path is None:
            return
        writes = (isinstance(mode, str) and any(c in mode for c in "wax+")) or (
            isinstance(flags, int) and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
        if writes:
            log.append(os.path.abspath(os.fsdecode(path)))
    elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove", "os.rmdir", "os.symlink", "os.link"):
        log.append(os.path.abspath(os.fsdecode(args[0])))
    elif event == "subprocess.Popen":
        log.append("exec " + repr(args[1]))
sys.addaudithook(hook)
sys.path.insert(0, sys.argv[1])
import tiny_cell
from benchmark import run
root = tiny_cell.make_root(os.path.join(os.environ["TMPDIR"], "root"))
run.open_card = tiny_cell.no_card
rc = run.main(["--workload", tiny_cell.CELL, "--seed", "5", "--seconds", "3", "--trace", "0"], root=root)
print(json.dumps({"rc": rc, "log": log}))
"""


def test_writes_stay_in_the_checkout_and_the_given_directories(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    dirs = {k: str(tmp_path / k.lower()) for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR")}
    for d in dirs.values():
        os.makedirs(d)
    env.update(dirs)
    out = subprocess.run([sys.executable, "-c", CODE, TESTS], cwd=spec.ROOT, env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["rc"] == 0
    allowed = [os.path.realpath(spec.ROOT), *map(os.path.realpath, dirs.values())]
    paths = [p for p in rec["log"] if not p.startswith("exec ")]
    assert paths, "the hook saw no write at all"
    for p in paths:
        real = os.path.realpath(p)
        assert real == "/dev/null" or any(real == a or real.startswith(a + os.sep) for a in allowed), p
        assert not real.startswith("/dev/shm")
