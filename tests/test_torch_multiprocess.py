"""Real multi-process distribution of the port on the CPU: two processes
join one gloo group through `asset_asrl_torch.distributed.initialize`,
each holding 4 shards of a (2, 4) ("host", "chip") mesh, and run
`asset_asrl_torch/tools/mp_worker.py`: the hierarchical and the flat
sharded factor + solve with cross-process collectives against the dense
solve (1e-8) and the exact inertia, a 2-rank `make_batched_step` against
one rank's (1e-12), and a sharded CartPole solve against the block
backend (the mirror of `tests/test_multiprocess.py`)."""

import os
import re
import socket
import subprocess
import sys

# the port's tests run on the CPU (the workers ask for it themselves)
import asset_asrl_torch.config
asset_asrl_torch.config.use_device("cpu")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_solves():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "asset_asrl_torch.tools.mp_worker",
         str(rank), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("MP-OK")]
        assert line and f"rank={rank}" in line[0], out[-4000:]
        # the collectives really crossed the group
        counts = [int(n) for n in re.findall(r"'all_gather': (\d+)",
                                             line[0])]
        assert len(counts) == 4 and min(counts) > 0, line[0]
