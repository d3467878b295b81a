#!/usr/bin/env python3
"""Run a command in a session of its own and list the processes of that
session that are still running once it has exited.

    python3 tools/session_leftovers.py -- python3 chip_smoke.py

The command's output passes through.  Then one line
``session_leftovers: rc=<command's exit code> left=<JSON list of
[pid, command line]>``.  Exits with the command's code, or with 3 if it
exited 0 and left a process behind: a program that stops every process it
starts leaves the list empty.  A process that starts a session of its own
(``setsid``) escapes the list.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def live_processes() -> list:
    """``(pid, ppid, session id, command line)`` of every live process
    (zombies aside)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:  # it ended while it was read
            continue
        # the fields after the command name: state, ppid, pgrp, session
        if fields[0] != "Z":
            out.append((int(pid), int(fields[1]), int(fields[3]),
                        cmd.strip()))
    return out


def children(pid: int) -> list:
    """The command lines of ``pid``'s live children."""
    return [cmd for _, ppid, _, cmd in live_processes() if ppid == pid]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--"]:
        argv = argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    proc = subprocess.Popen(argv, start_new_session=True)
    rc = proc.wait()
    # the session's id is its leader's pid; read at once, with no grace: a
    # child the command waited for is gone, one it did not is still here
    left = [[pid, cmd] for pid, _, sid, cmd in live_processes()
            if sid == proc.pid]
    print(f"session_leftovers: rc={rc} left={json.dumps(left)}", flush=True)
    return rc if rc or not left else 3


if __name__ == "__main__":
    sys.exit(main())
