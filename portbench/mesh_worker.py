"""One worker rank of the `mesh` request form (`forms/mesh.py`), started
by rank 0, the harness's process, with the SURF_* launch contract in its
environment and its part on the command line:

    python3 -m portbench.mesh_worker '<json: surf, mix, pool_shape,
        device, backend, timeout_s, parent>'

It joins the process group through `parallel.multihost.initialize_from_env`
on its device, receives the input pool from rank 0, and serves each request
whose index rank 0 writes to its standard input, a line each, until `stop`
or the end of the input.  It writes nothing to standard output, and ends
itself when rank 0's process (`parent`) is gone.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import torch


def _watch(parent: int):
    while os.getppid() == parent:
        time.sleep(0.2)
    os._exit(1)


def main(argv=None) -> int:
    part = json.loads((sys.argv[1:] if argv is None else argv)[0])
    threading.Thread(target=_watch, args=(part["parent"],),
                     daemon=True).start()
    device = torch.device(part["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    from cuda_surf_tpu_torch import BatchSurf, SurfConfig
    from cuda_surf_tpu_torch.parallel import initialize_from_env, make_mesh

    from .forms.mesh import serve
    from .reference.precision import fp32
    from .scenes.plane import PlaneInputs
    initialize_from_env(timeout_s=part["timeout_s"], backend=part["backend"],
                        device=device)
    pool = torch.empty(part["pool_shape"], dtype=torch.uint8, device=device)
    torch.distributed.broadcast(pool, src=0)
    inputs = PlaneInputs(part["mix"], pool)
    bs = BatchSurf(SurfConfig(**part["surf"]), device.type, mesh=make_mesh())
    for line in sys.stdin:
        if line.strip() == "stop":
            break
        with fp32():
            serve(bs, inputs.frames_of(int(line)))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
