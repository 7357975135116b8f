"""Seeded data and request streams, made on the device in a few large calls.

Frozen torch rewrites of the generators in
``src/repro_torch/data/timeseries.py``:

  * :func:`random_walks`: cumulative sums of N(0, 1) steps, the synthetic
    data of the UCR Suite (as streams) and of the Hydra benchmark's Synth
    (as whole series), returned raw: the service and the reference
    z-normalise them themselves;
  * :func:`whole_series_queries` after ``make_queries`` (database rows,
    z-normalised, plus noise 0.05, z-normalised again);
  * :func:`subseq_queries` after ``make_subseq_queries`` (windows at
    random stream positions plus noise 0.05, raw).

Everything draws from ``torch.Generator`` objects on the data's device,
so one seed gives the same data on one kind of device.  Nothing here
imports the program.
"""
from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 64))
    return gen


def _znorm64(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    mu = x.mean(dim=-1, keepdim=True)
    sd = (x - mu).pow(2).mean(dim=-1, keepdim=True).sqrt()
    return (x - mu) / sd.clamp_min(1e-8)


def random_walks(n_streams: int, stream_len: int,
                 gen: torch.Generator) -> torch.Tensor:
    """(n_streams, stream_len) float32 random walks: cumulative sums (in
    f64) of N(0, 1) steps."""
    steps = torch.randn((n_streams, stream_len), generator=gen,
                        dtype=torch.float64, device=gen.device)
    return torch.cumsum(steps, dim=-1).float()


def whole_series_queries(series: torch.Tensor, n_queries: int,
                         gen: torch.Generator,
                         noise: float = 0.05) -> torch.Tensor:
    """(n_queries, n) float32: z-normalised database rows plus noise,
    z-normalised."""
    rows = torch.randint(0, series.shape[0], (n_queries,), generator=gen,
                         device=series.device)
    base = _znorm64(series[rows])
    q = base + noise * torch.randn(base.shape, generator=gen,
                                   dtype=torch.float64, device=base.device)
    return _znorm64(q).float()


def subseq_queries(streams: torch.Tensor, n_queries: int, window: int,
                   gen: torch.Generator, noise: float = 0.05) -> torch.Tensor:
    """(n_queries, window) float32 raw windows at random positions plus
    noise (the engines and the reference z-normalise them)."""
    S, L = streams.shape
    dev = streams.device
    rows = torch.randint(0, S, (n_queries, 1), generator=gen, device=dev)
    starts = torch.randint(0, L - window + 1, (n_queries, 1), generator=gen,
                           device=dev)
    cols = starts + torch.arange(window, device=dev)[None, :]
    q = streams[rows, cols].double()
    q = q + noise * torch.randn(q.shape, generator=gen, dtype=torch.float64,
                                device=dev)
    return q.float()


def request_mix(n_requests: int, knn_frac: float, epsilons,
                gen: torch.Generator) -> tuple:
    """``(is_knn (R,) bool, eps (R,) float)`` on the host: ``knn_frac``
    of the requests k-NN, the rest cycling through ``epsilons``, in an
    order drawn from ``gen``."""
    n_knn = int(round(knn_frac * n_requests))
    eps_list = [float(e) for e in epsilons] or [0.0]
    kinds = [True] * n_knn
    eps = [0.0] * n_knn
    n_range = n_requests - n_knn
    for i in range(n_range):
        kinds.append(False)
        eps.append(eps_list[i % len(eps_list)])
    perm = torch.randperm(n_requests, generator=gen,
                          device=gen.device).cpu().tolist()
    return ([kinds[p] for p in perm], [eps[p] for p in perm])


def arrivals(rate: float, seconds: float) -> list:
    """Arrival offsets in seconds, 1 / ``rate`` apart from 0, every one
    before ``seconds``: a caller on a fixed cadence."""
    rate = float(rate)
    return [i / rate for i in range(int(rate * float(seconds)) + 1)
            if i / rate < float(seconds)]
