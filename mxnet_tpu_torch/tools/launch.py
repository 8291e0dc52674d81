#!/usr/bin/env python
"""Multi-process launcher (ref: tools/launch.py over dmlc-core trackers,
which set DMLC_ROLE/DMLC_PS_ROOT_* per process).

The port's own copy of the repo's ``tools/launch.py``, with the same flags
and environment. There are no parameter-server roles: every process is a
worker. Each gets ``MXTPU_COORD`` (the control plane's ``host:port``, which
rank 0's ``torch.distributed.TCPStore`` binds), ``MXTPU_RANK`` and
``MXTPU_NPROC``; the program calls ``mxnet_tpu_torch.tools_init_distributed()``
(or creates a dist kvstore, which opens the plane itself).

Launchers:
  local — spawn N worker processes on this host
  ssh   — spawn one worker per host in --host-file via ssh

Run: ``python -m mxnet_tpu_torch.tools.launch -n 2 --coord-port P python
train.py``. The exit code is the last nonzero worker exit code, else 0.
"""
import argparse
import os
import subprocess
import sys


def launch_local(n, command, coord_port=12421):
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update(MXTPU_COORD="localhost:%d" % coord_port,
                   MXTPU_RANK=str(rank), MXTPU_NPROC=str(n),
                   JAX_PLATFORMS=env.get("JAX_PLATFORMS", ""))
        procs.append(subprocess.Popen(command, shell=True, env=env))
    code = 0
    for p in procs:
        code = p.wait() or code
    return code


def launch_ssh(host_file, command, coord_port=12421):
    with open(host_file) as f:
        hosts = [h.strip() for h in f if h.strip()]
    coord = "%s:%d" % (hosts[0], coord_port)
    procs = []
    for rank, host in enumerate(hosts):
        env_prefix = ("MXTPU_COORD=%s MXTPU_RANK=%d MXTPU_NPROC=%d"
                      % (coord, rank, len(hosts)))
        procs.append(subprocess.Popen(
            ["ssh", "-o", "StrictHostKeyChecking=no", host,
             "cd %s && %s %s" % (os.getcwd(), env_prefix, command)]))
    code = 0
    for p in procs:
        code = p.wait() or code
    return code


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-n", "--num-workers", type=int, required=True)
    parser.add_argument("--launcher", choices=["local", "ssh"],
                        default="local")
    parser.add_argument("--host-file", default=None)
    parser.add_argument("--coord-port", type=int, default=12421,
                        help="control-plane (TCPStore) port")
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args()
    command = " ".join(args.command)
    if args.launcher == "local":
        sys.exit(launch_local(args.num_workers, command, args.coord_port))
    else:
        assert args.host_file, "ssh launcher needs --host-file"
        sys.exit(launch_ssh(args.host_file, command, args.coord_port))


if __name__ == "__main__":
    main()
