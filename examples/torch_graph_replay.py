"""CUDA graphs on the PyTorch port of COX: stream capture, instantiate,
replay (port of ``examples/graph_replay.py``).

The CUDA idiom this ports:

    cudaStreamBeginCapture(s, cudaStreamCaptureModeGlobal);
    step1<<<grid, block, 0, s>>>(tmp, x, y, n);
    step2<<<grid, block, 0, s>>>(out, tmp, n);      // depends on step1
    cudaStreamEndCapture(s, &graph);
    cudaGraphInstantiate(&exec, graph, 0);
    for (int t = 0; t < T; ++t) {
        cudaGraphExecKernelNodeSetParams(exec, ...); // rebind inputs
        cudaGraphLaunch(exec, s);                    // zero re-dispatch
    }

Here ``graph.capture(stream)`` records every launch (and event edge)
issued on the stream *without dispatching*; ``instantiate()`` stages the
captured DAG once -- on the card as a ``torch.cuda.CUDAGraph`` whose
intermediates pass from producer to consumer in device memory -- and
``replay(**bindings)`` copies rebound inputs into the graph's static
buffers and replays it, with no per-launch host work.  Replay is
bitwise-equal to issuing the same launches eagerly.

    PYTHONPATH=src python examples/torch_graph_replay.py [--device cpu] [--iters 40]

Everything runs on the CUDA card unless ``--device`` names another
device, and raises where there is no card.
"""

import argparse
import statistics
import time

import numpy as np

from repro_torch.core import cox
from repro_torch.core.runtime import resolve_device
from repro_torch.core.streams import Dispatcher


@cox.kernel
def saxpy(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), y: cox.Array(cox.f32), n: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = 2.5 * x[i] + y[i]


@cox.kernel
def scale(c, out: cox.Array(cox.f32), x: cox.Array(cox.f32), n: cox.i32):
    i = c.block_idx() * c.block_dim() + c.thread_idx()
    if i < n:
        out[i] = x[i] * 0.5 + 1.0


def host(t) -> np.ndarray:
    return t.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--iters", type=int, default=40, help="timing rounds")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # the card's launches go through the process-wide dispatcher; another
    # device gets a dispatcher of its own over that one device
    on_card = device.type == "cuda"
    disp = cox.get_dispatcher() if on_card else Dispatcher(devices=[device])
    dev = None if on_card else device

    grid, block = 32, 256
    n = grid * block
    x = np.arange(n, dtype=np.float32) / n
    y = np.ones(n, np.float32)
    o = np.zeros(n, np.float32)

    s = cox.Stream("capture", disp)

    # ---- capture: record the 2-launch chain, nothing dispatches ----
    g = cox.Graph(name="saxpy-scale")
    with g.capture(s):
        h1 = s.launch(saxpy, grid=grid, block=block, args=(o, x, y, n))
        s.launch(scale, grid=grid, block=block, args=(o, h1.outputs["out"], n))  # data edge, not a sync
    exe = g.instantiate()
    print(f"captured {len(g.nodes)} launches; inputs={list(exe.input_names)}")

    # ---- replay == the same launches issued eagerly, bitwise ----
    r1 = saxpy.launch(grid=grid, block=block, args=(o, x, y, n), device=dev)
    eager = host(scale.launch(grid=grid, block=block, args=(o, r1["out"], n), device=dev)["out"])
    replayed = host(exe.replay()["out"])
    np.testing.assert_array_equal(replayed, eager)
    print("bitwise: replay == eager launches")

    # ---- rebind and replay: new inputs, zero re-capture ----
    x2 = x[::-1].copy()
    rebound = host(exe.replay(x=x2)["out"])
    want2 = (2.5 * x2 + y) * 0.5 + 1.0
    np.testing.assert_array_equal(rebound, want2.astype(np.float32))
    print("rebound replay: exe.replay(x=reversed) correct")

    # ---- timing: per-launch dispatch vs one replay per "token" ----
    def eager_chain(xv):
        h = s.launch(saxpy, grid=grid, block=block, args=(o, xv, y, n))
        h = s.launch(scale, grid=grid, block=block, args=(o, h.outputs["out"], n))
        return host(h.result()["out"])

    def replay(xv):
        return host(exe.replay(x=xv)["out"])

    eager_chain(x), replay(x)  # warm both paths
    te, tg = [], []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        eager_chain(x)
        te.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        replay(x)
        tg.append(time.perf_counter() - t0)
    eager_ms = statistics.median(te) * 1e3
    replay_ms = statistics.median(tg) * 1e3
    print(f"eager dispatch: {eager_ms:7.2f} ms")
    print(f"graph replay:   {replay_ms:7.2f} ms ({eager_ms / replay_ms:.2f}x)")
    return {
        "eager": eager,
        "replay": replayed,
        "rebound": rebound,
        "eager_ms": eager_ms,
        "replay_ms": replay_ms,
        "cuda_graph": exe.cuda_graph is not None,
    }


if __name__ == "__main__":
    main()
