"""Can one captured CUDA graph hold kernel and copy nodes of several cards?

    python -m accord_tpu_torch.tools.multicard_graph_probe   # 2+ cards

Captures on card 0's stream, joins card 1's stream into the capture by an
event, launches a kernel and peer copies there, joins back, then replays
the graph twice: `captured` says whether the capture was accepted, and
the values after each replay (b, c on the cards) must read (3, 3) and
(5, 5). This is the question the sharded protocol megakernel's graph form
across cards depends on (parallel/mesh.sharded_protocol_tick runs such a
mesh stage by stage). Prints one JSON line; with fewer than two cards
only the card count.
"""
from __future__ import annotations

import json

import torch


def probe() -> dict:
    n = torch.cuda.device_count()
    out = {"cards": n}
    if n < 2:
        return out
    a = torch.ones(1 << 20, device="cuda:0")
    b = torch.zeros(1 << 20, device="cuda:1")
    c = torch.zeros(1 << 20, device="cuda:0")
    s0 = torch.cuda.Stream(device=0)
    s1 = torch.cuda.Stream(device=1)
    g = torch.cuda.CUDAGraph()

    def sync():
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
    try:
        with torch.cuda.device(0), torch.cuda.stream(s0):
            g.capture_begin(capture_error_mode="relaxed")
            try:
                a.mul_(2)
                e0 = torch.cuda.Event()
                e0.record(s0)
                with torch.cuda.device(1):
                    s1.wait_event(e0)
                    with torch.cuda.stream(s1):
                        b.copy_(a, non_blocking=True)
                        b.add_(1)
                        c.copy_(b, non_blocking=True)
                    e1 = torch.cuda.Event()
                    e1.record(s1)
                s0.wait_event(e1)
            finally:
                g.capture_end()
        a.fill_(1)
        sync()
        g.replay()
        sync()
        first = (float(b[0]), float(c[0]))
        g.replay()
        sync()
        out.update(captured=True, after_one=first,
                   after_two=(float(b[0]), float(c[0])),
                   expect=((3.0, 3.0), (5.0, 5.0)))
    except RuntimeError as e:
        out.update(captured=False, error=f"{e}"[:500])
    return out


if __name__ == "__main__":
    print(json.dumps(probe()))
