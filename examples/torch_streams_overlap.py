"""CUDA streams & events on the PyTorch port of COX: cross-stream overlap
of independent kernels (port of ``examples/streams_overlap.py``).

The CUDA idiom this ports:

    cudaStream_t s1, s2;  cudaEvent_t start, stop;
    saxpy<<<grid, block, 0, s1>>>(o1, x, y, n);
    scale<<<grid, block, 0, s2>>>(o2, x, n);       // overlaps s1
    cudaEventRecord(stop, s2); ...
    cudaStreamSynchronize(s1); cudaStreamSynchronize(s2);

Here ``cox.Stream.launch`` enqueues a request and returns a
``LaunchHandle`` future; the dispatcher stages each launch once (all
streams share the stage cache) and issues each cox stream's launches on
a ``torch.cuda.Stream`` of its own, so the card runs stream 2's kernels
while stream 1's are still executing.  Events order streams against
each other and time the pipeline (``torch.cuda.Event`` on the card).

    PYTHONPATH=src python examples/torch_streams_overlap.py [--device cpu] [--iters 20]

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
        out[i] = x[i] * 3.0 + 1.0


def host(t) -> np.ndarray:
    return t.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--iters", type=int, default=20, help="timing rounds")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # the card's launches go through the process-wide dispatcher; another
    # device gets a dispatcher of its own over that one device
    on_card = device.type == "cuda"
    disp = cox.get_dispatcher() if on_card else Dispatcher(devices=[device])
    dev = None if on_card else device

    grid, block = 32, 256
    n = grid * block  # one element per thread, full coverage
    x = np.arange(n, dtype=np.float32) / n
    y = np.ones(n, np.float32)
    o = np.zeros(n, np.float32)
    a1, a2 = (o, x, y, n), (o, x, n)

    s1, s2 = cox.Stream("s1", disp), cox.Stream("s2", disp)

    # ---- serial issue: launch + synchronize, one after the other ----
    ref1 = host(saxpy.launch(grid=grid, block=block, args=a1, device=dev)["out"])
    ref2 = host(scale.launch(grid=grid, block=block, args=a2, device=dev)["out"])

    # ---- two streams: issue both, then synchronize ----
    h1 = s1.launch(saxpy, grid=grid, block=block, args=a1)
    h2 = s2.launch(scale, grid=grid, block=block, args=a2)
    out1, out2 = host(h1.result()["out"]), host(h2.result()["out"])

    # any legal stream schedule is bitwise-identical to serial issue
    np.testing.assert_array_equal(out1, ref1)
    np.testing.assert_array_equal(out2, ref2)
    print("bitwise: 2-stream issue == serial issue")

    # ---- event edge: s2 waits on s1's tail before its next launch ----
    h1 = s1.launch(saxpy, grid=grid, block=block, args=a1)
    ev = s1.record_event()
    s2.wait_event(ev)
    h2 = s2.launch(scale, grid=grid, block=block, args=(o, h1.outputs["out"], n))  # chained, no host sync
    chained = host(h2.result()["out"])
    want = ref1 * 3.0 + 1.0
    np.testing.assert_array_equal(chained, want)
    print("event edge + handle chaining: scale(saxpy(x)) correct")

    # ---- timing: serial issue vs 2-stream issue (events time it) ----
    # both paths bring every result to host numpy; "serial" does it
    # launch by launch, "streams" issues everything first
    ts, to, ev_ms = [], [], []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        host(saxpy.launch(grid=grid, block=block, args=a1, device=dev)["out"])
        host(scale.launch(grid=grid, block=block, args=a2, device=dev)["out"])
        ts.append(time.perf_counter() - t0)

        start = cox.Event().record(s1)
        t0 = time.perf_counter()
        h1 = s1.launch(saxpy, grid=grid, block=block, args=a1)
        h2 = s2.launch(scale, grid=grid, block=block, args=a2)
        host(h1.result()["out"])
        host(h2.result()["out"])
        to.append(time.perf_counter() - t0)
        stop = cox.Event().record(s2)
        ev_ms.append(start.elapsed(stop))  # the CUDA-style timing API

    serial_ms = statistics.median(ts) * 1e3
    stream_ms = statistics.median(to) * 1e3
    print(f"serial issue:   {serial_ms:7.2f} ms")
    print(f"2-stream issue: {stream_ms:7.2f} ms ({serial_ms / stream_ms:.2f}x)")
    return {
        "saxpy": out1,
        "scale": out2,
        "chained": chained,
        "serial_ms": serial_ms,
        "stream_ms": stream_ms,
        "event_ms": statistics.median(ev_ms),
    }


if __name__ == "__main__":
    main()
