"""A continuously running aggregation service on the buffered-async
engine: the port's twin of ``examples/serve_async.py``.

A request queue takes training requests (each asks for a few more
rounds); a worker thread drains the queue in batches into one resident
``repro_torch.fed.AsyncRunner``, so each drain is one engine call, one
segment of rounds that never waits for the device, and clients read
their round records and admission counts back. The model, the optimizer
state, the per-device staleness counters and the churn chain persist
across requests.

Run:  PYTHONPATH=src python examples/torch_serve_async.py
      (on a CUDA card; add --device cpu to run on the CPU)
"""
import argparse
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.configs import LTFLConfig
from repro_torch.data import ArrayDataset, synthetic_cifar
from repro_torch.fed import (AsyncRunner, ChurnSpec, FedSGDScheme,
                             resolve_device)
from repro_torch.models import MLP


@dataclass
class TrainRequest:
    """Ask the service for ``rounds`` more buffered-async rounds."""

    rounds: int
    done: threading.Event = field(default_factory=threading.Event)
    records: List = field(default_factory=list)
    admitted: List[int] = field(default_factory=list)

    def result(self, timeout: float = 300.0):
        if not self.done.wait(timeout):
            raise TimeoutError("aggregation service stalled")
        return self.records


class AggregationService:
    """A batched queue in front of a resident ``AsyncRunner``: requests
    are drained in arrival order and their round counts fused into one
    engine call per drain."""

    def __init__(self, runner: AsyncRunner, max_batch: int = 8):
        self.runner = runner
        self.max_batch = max_batch
        self.q: "queue.Queue[Optional[TrainRequest]]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, req: TrainRequest) -> TrainRequest:
        self.q.put(req)
        return req

    def shutdown(self):
        self.q.put(None)
        self._thread.join()

    def _worker(self):
        while True:
            req = self.q.get()
            if req is None:
                return
            batch = [req]
            while len(batch) < self.max_batch:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self.q.put(None)     # re-post the stop marker
                    break
                batch.append(nxt)
            total = sum(r.rounds for r in batch)
            before = len(self.runner.async_history)
            records = self.runner.run(total)[-total:]   # the new tail
            diag = self.runner.async_history[before:]
            lo = 0
            for r in batch:              # hand each request its slice
                r.records = records[lo:lo + r.rounds]
                r.admitted = [d["n_admitted"]
                              for d in diag[lo:lo + r.rounds]]
                lo += r.rounds
                r.done.set()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--deadline", type=float, default=350.0)
    ap.add_argument("--buffer", type=int, default=3)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ltfl = LTFLConfig(num_devices=6, samples_min=40, samples_max=60)
    imgs, labels = synthetic_cifar(1024, seed=0)
    timgs, tlabels = synthetic_cifar(256, seed=1)
    train = ArrayDataset({"images": imgs, "labels": labels})
    test = ArrayDataset({"images": timgs, "labels": tlabels})
    model = MLP()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)

    runner = AsyncRunner(
        model, params, ltfl, train, test, FedSGDScheme(),
        batch_size=16, seed=0, eval_every=0, device=device,
        deadline=args.deadline, buffer_size=args.buffer,
        churn=ChurnSpec(p_depart=0.05, p_return=0.3, p_drop=0.05))
    svc = AggregationService(runner)
    print(f"service up on {device}: U={ltfl.num_devices} "
          f"deadline={args.deadline}s buffer={args.buffer} (the "
          f"synchronous engine: deadline=inf, buffer={ltfl.num_devices}, "
          f"no churn)")

    # a burst of requests lands together: one fused engine call
    t0 = time.time()
    reqs = [svc.submit(TrainRequest(rounds=2 + i % 2))
            for i in range(args.clients)]
    for i, r in enumerate(reqs):
        recs = r.result()
        print(f"client {i}: {len(recs)} rounds, "
              f"loss {recs[-1].train_loss:.4f}, "
              f"admitted/round {r.admitted}, "
              f"mean tau {sum(x.staleness for x in recs) / len(recs):.2f}")
    print(f"burst served in {time.time() - t0:.1f}s wall "
          f"(simulated time {runner.history[-1].cum_delay:.0f}s)")

    # later requests ride the same resident engine
    svc.submit(TrainRequest(rounds=2)).result()
    print(f"follow-up served; engine has aggregated "
          f"{len(runner.history)} rounds total, staleness now "
          f"{runner.staleness.mean():.2f}")
    svc.shutdown()


if __name__ == "__main__":
    main()
