"""The plain reference of the simulator the benchmark drives: the same
scenario worked out again from the trace alone, in plain PyTorch, chunk by
chunk, with nothing of the program imported or taken from it.

Per chunk of ``daemon_interval`` requests, on the replica map frozen at the
chunk's start (paper §8, Algorithms 1-3):

1. the M/M/1 pre-pass, where the configuration has ``contention``: each
   request's serving node (reads: the nearest replica, the first on an RTT
   tie, the requesting node when the key has none; writes: the requesting
   node), its demand ``service + bytes / serve``, each node's load factor
   ``rho = min(demand folded over the chunk / capacity, rho_max)`` and the
   wait ``d * rho / (1 - rho)``;
2. the replay pricing: a read pays ``service + RTT to the nearest replica``
   (the worst RTT of the topology when the key has no replica); a write
   pays ``service`` when its node is the key's only holder, else ``service
   + relay to the master + the master's post to the farthest other
   holder``; then the wait;
3. busy time a node, the latency sum, hits and reads (f64 and int64
   accumulators), and with ``telemetry`` the ``[2N, B]`` log-bin histogram
   of the chunk;
4. the occupancy of the frozen map (its running peak);
5. the access counts, then Algorithm 3's sweep: a node owns a touched key
   where its share of the key's accesses is at least ``h`` (the first
   busiest node where none is), an untouched key keeps its placement;
   where the configuration has ``capacity_bytes``, the projection keeps on
   each node the owned candidates in order of share (held before added at
   equal share, then by key id) while their bytes fit the budget.

The f32 expressions are those of the simulator's model, in its order, so
that an exact answer (a histogram bin, a move) comes out the same:
latencies and waits in f32, the demand fold in f64 rounded once, the load
factor as the fold times the f32 reciprocal of the capacity, the log of a
bin in f64 rounded to f32. ``dtype`` computes the per-request latencies,
demands, waits and load factors in another float type; the control passes
``torch.bfloat16``. The sums stay in f64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["replay", "bin_index", "quantile_rows", "bin_edges", "QUANTILES"]

QUANTILES = (0.5, 0.9, 0.95, 0.99, 0.999)


def _scalar(x: float, dtype, device) -> torch.Tensor:
    return torch.full((), float(x), dtype=dtype, device=device)


def bin_index(lat: torch.Tensor, lo: float, hi: float, num_bins: int) -> torch.Tensor:
    """Bin of each latency: 0 below ``lo``, ``num_bins - 1`` from ``hi``,
    else ``1 + floor(log(lat / lo) / log(hi / lo) * (num_bins - 2))``
    clamped to the interior, the logarithms in f64 rounded to f32."""
    lat = lat.to(torch.float32)
    dev = lat.device
    lo_t, hi_t = _scalar(lo, torch.float32, dev), _scalar(hi, torch.float32, dev)
    inner = num_bins - 2
    num = torch.log((torch.clamp_min(lat, 1e-30) / lo_t).double()).to(torch.float32)
    den = torch.log((hi_t / lo_t).double()).to(torch.float32)
    t = (num / den) * _scalar(inner, torch.float32, dev)
    raw = torch.clamp(torch.floor(t).to(torch.int32) + 1, 1, inner)
    idx = torch.where(lat >= hi_t, torch.full_like(raw, num_bins - 1), raw)
    return torch.where(lat < lo_t, torch.zeros_like(raw), idx)


def bin_edges(lo: float, hi: float, num_bins: int) -> np.ndarray:
    """``[B + 1]`` edges: ``[0, lo, ..., hi, inf]``, log-spaced inside."""
    inner = num_bins - 2
    return np.concatenate([[0.0], lo * (hi / lo) ** (np.arange(inner + 1) / inner), [np.inf]])


def quantile_rows(hists: np.ndarray, edges: np.ndarray, q: float) -> np.ndarray:
    """Quantile ``q`` of each ``[B]`` row, spread geometrically inside its
    bin (linearly in the first), clamped to ``lo`` in the underflow bin and
    to ``hi`` in the overflow bin; ``nan`` for an empty row."""
    hists = np.asarray(hists, dtype=np.float64)
    out = np.full(hists.shape[0], np.nan)
    for i, h in enumerate(hists):
        total = h.sum()
        if total <= 0:
            continue
        target = q * total
        cum = np.cumsum(h)
        b = min(int((cum < target).sum()), len(h) - 1)
        prev = cum[b - 1] if b > 0 else 0.0
        frac = min(max((target - prev) / max(h[b], 1e-12), 0.0), 1.0)
        lo_e, hi_e = edges[b], edges[b + 1]
        if b == 0:
            out[i] = edges[1]
        elif not math.isfinite(hi_e):
            out[i] = lo_e
        else:
            out[i] = lo_e * (hi_e / lo_e) ** frac
    return out


def _latency(hosts, keys, nodes, is_read, rtt, *, service, master, dtype):
    """Per-request latency ``[B]`` (``dtype``) on the frozen map, and the
    read hits ``[B]`` bool."""
    dev = rtt.device
    b, n = keys.shape[0], rtt.shape[0]
    rows = hosts[keys]  # [B, N]
    node = nodes.long()
    own = rows[torch.arange(b, device=dev), node]
    rtt_row = rtt[node]  # [B, N]
    inf = _scalar(float("inf"), dtype, dev)
    nearest = torch.where(rows, rtt_row, inf).amin(dim=1)
    nearest = torch.where(torch.isfinite(nearest), nearest, rtt.max())
    svc = _scalar(service, dtype, dev)
    zero = _scalar(0.0, dtype, dev)
    read_lat = svc + nearest
    relay = torch.where(node == master, zero, rtt[node, master])
    others = torch.arange(n, device=dev) != master
    post = torch.where(rows & others, rtt[master][None, :], zero).amax(dim=1)
    sole = own & (rows.sum(dim=1) == 1)
    write_lat = svc + torch.where(sole, zero, relay + post)
    return torch.where(is_read, read_lat, write_lat), own & is_read


def _contention_wait(hosts, keys, nodes, is_read, rtt, obj, cont, *, service, capacity_ms, dtype):
    """The M/M/1 pre-pass: ``(wait [B], rho [N])`` in ``dtype``."""
    dev = rtt.device
    n = rtt.shape[0]
    node = nodes.long()
    rows = hosts[keys]
    inf = _scalar(float("inf"), dtype, dev)
    nearest = torch.where(rows, rtt[node], inf).argmin(dim=1)
    serving = torch.where(is_read & rows.any(dim=1), nearest, node)
    # service + bytes / serve, as one rounding of bytes * f32(1 / serve) + service
    inv_serve = float(np.float32(1.0) / np.float32(cont["serve_bytes_per_ms"]))
    demand = (obj[keys].double() * inv_serve + float(np.float32(service))).to(dtype)
    fold = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, serving, demand.double())
    inv_cap = float(np.float32(1.0) / np.float32(capacity_ms))
    rho = torch.minimum(fold.to(dtype) * _scalar(inv_cap, dtype, dev),
                        _scalar(cont["rho_max"], dtype, dev))
    r = rho[serving]
    return demand * r / (_scalar(1.0, dtype, dev) - r), rho


def _project(owners, hosts, f, obj, budget):
    """Trim ``owners`` to the per-node byte ``budget``: ``(kept, evicted)``
    ``[K, N]`` bool. Within a node, candidates are taken in order of share
    (descending), a held replica before an add at equal share, then by key
    id, and admitted while the running byte total fits."""
    k, n = owners.shape
    dev = owners.device
    held = owners & hosts
    bits = f.t().contiguous().view(torch.int32).to(torch.int64)  # f >= 0: bits order like f
    node = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    key = ((node << 35) | ((~owners.t()).to(torch.int64) << 33)
           | ((2**31 - 1 - bits) << 1) | (~held.t()).to(torch.int64))
    perm = torch.sort(key.reshape(-1), stable=True).indices
    owned = owners.t().reshape(-1)[perm]
    size = torch.where(owned, obj.double()[perm % k], torch.zeros((), dtype=torch.float64, device=dev))
    # One 1-D scan a node: a scan along a [N, K] row of a 2-D tensor runs
    # one thread a row on the card.
    cum = torch.cat([torch.cumsum(row, 0) for row in size.view(n, k)]).view(n, k)
    fits = owned & (cum <= budget.double()[:, None]).reshape(-1)
    admit = torch.empty_like(fits).scatter_(0, perm, fits).view(n, k).t()
    return owners & admit, held & ~admit


def _sweep(counts, hosts, h: float):
    """Algorithm 3's candidate set and the shares ``f`` (f32)."""
    c = counts.to(torch.float32)
    n = c.shape[1]
    total = c[:, :1]
    for j in range(1, n):
        total = total + c[:, j:j + 1]
    f = torch.where(total > 0, c / torch.clamp_min(total, 1.0), torch.zeros_like(c))
    mask = f >= torch.full((), h, dtype=torch.float32, device=c.device)
    touched = total[:, 0] > 0
    first_max = torch.where(c == c.amax(dim=1, keepdim=True),
                            torch.arange(n, device=c.device), n).amin(dim=1)
    guard = touched & ~mask.any(dim=1)
    eligible = torch.where(guard[:, None], torch.arange(n, device=c.device) == first_max[:, None], mask)
    return torch.where(touched[:, None], eligible, hosts), f


def replay(config: dict, natural: torch.Tensor, object_bytes: torch.Tensor, keys: torch.Tensor,
           nodes: torch.Tensor, is_read: torch.Tensor, *, dtype=torch.float32) -> dict:
    """Replay one trace under ``config``'s deployment and policy. Returns
    the answers: ``throughput_ops_s``, ``hit_rate``, ``mean_latency_ms``,
    ``node_busy_ms [N]``, ``peak_occupancy_bytes [N]``, ``moves [4]``
    (replicas added, dropped, expired, evicted by the budget) and, with
    telemetry, the series ``hist [C, 2N, B]``, ``hits``, ``reads``,
    ``count``, ``lat_sum``, ``adds``, ``drops``, ``expired``,
    ``capacity_evictions`` ``[C]``, ``occupancy`` and ``load_factor``
    ``[C, N]``, as numpy."""
    policy = config["policy"]
    if policy["name"] != "redynis" or policy.get("expiry", 0) or policy.get("period", 1) != 1:
        raise ValueError(f"the reference replays Redynis sweeping every tick, got {policy}")
    dev = keys.device
    k, n = natural.shape[0], config["num_nodes"]
    r = keys.shape[0]
    interval = config["daemon_interval"]
    h = policy["h"] if policy["h"] is not None else 1.0 / n
    decay = policy.get("decay", 1.0)
    service, master = config["service_ms"], config["master"]
    rtt = torch.tensor(config["rtt_ms"], dtype=dtype, device=dev)
    obj = object_bytes.to(torch.float32)
    cont = config.get("contention")
    tel = config.get("telemetry")
    budget = config.get("capacity_bytes")
    if budget is not None:
        budget = torch.full((n,), float(budget), dtype=torch.float32, device=dev)
    capacity_ms = None if cont is None else cont["capacity_factor"] * interval * service

    # Every key starts on the node after its natural one.
    hosts = ((natural.long() + 1) % n)[:, None] == torch.arange(n, device=dev)[None, :]
    counts = torch.zeros((k, n), dtype=torch.int32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    busy = torch.zeros(n, **f64)
    lat_sum = torch.zeros((), **f64)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    reads = torch.zeros((), dtype=torch.int64, device=dev)
    moves = torch.zeros(4, dtype=torch.int64, device=dev)

    def occupancy(m):
        return torch.where(m, obj.double()[:, None], torch.zeros((), **f64)).sum(dim=0)

    peak = occupancy(hosts)
    series = []
    for lo in range(0, r, interval):
        hi = min(lo + interval, r)
        ck, cn, cr = keys[lo:hi].long(), nodes[lo:hi], is_read[lo:hi]
        lat, hit = _latency(hosts, ck, cn, cr, rtt, service=service, master=master, dtype=dtype)
        rho = None
        if cont is not None:
            wait, rho = _contention_wait(hosts, ck, cn, cr, rtt, obj, cont, service=service,
                                         capacity_ms=capacity_ms, dtype=dtype)
            lat = lat + wait
        lat64 = lat.double()
        busy.index_add_(0, cn.long(), lat64)
        c_lat = lat64.sum()
        lat_sum += c_lat
        c_hits, c_reads = hit.sum(), cr.sum()
        hits += c_hits
        reads += c_reads
        occ = occupancy(hosts)
        peak = torch.maximum(peak, occ)
        counts.view(-1).index_add_(0, ck * n + cn.long(), torch.ones_like(ck, dtype=torch.int32))
        owners, f = _sweep(counts, hosts, h)
        evicted = None
        if budget is not None:
            owners, evicted = _project(owners, hosts, f, obj, budget)
        step = torch.stack([(owners & ~hosts).sum(), (hosts & ~owners).sum(),
                            torch.zeros((), dtype=torch.int64, device=dev),
                            torch.zeros((), dtype=torch.int64, device=dev) if evicted is None
                            else evicted.sum()])
        moves += step
        hosts = owners
        if decay != 1.0:
            counts = torch.floor(counts.to(torch.float32) * float(np.float32(decay))).to(torch.int32)
        if tel is not None:
            b = tel["num_bins"]
            group = cn.long() * 2 + cr.long()
            idx = bin_index(lat, tel["lo_ms"], tel["hi_ms"], b).long()
            hist = torch.zeros(2 * n * b, dtype=torch.int64, device=dev)
            hist.index_add_(0, group * b + idx, torch.ones_like(idx))
            series.append(dict(
                hist=hist.view(2 * n, b), hits=c_hits, reads=c_reads,
                count=torch.full((), hi - lo, dtype=torch.int64, device=dev), lat_sum=c_lat,
                adds=step[0], drops=step[1], expired=step[2], capacity_evictions=step[3],
                occupancy=occ,
                load_factor=torch.zeros(n, **f64) if rho is None else rho.double()))
    busy_h = busy.cpu().numpy()
    out = dict(
        throughput_ops_s=float(r / (busy_h.max() / 1000.0)),
        hit_rate=float(hits) / max(float(reads), 1.0),
        mean_latency_ms=float(lat_sum) / r,
        node_busy_ms=busy_h,
        peak_occupancy_bytes=peak.cpu().numpy(),
        moves=moves.cpu().numpy(),
    )
    if tel is not None:
        for name in series[0]:
            out[name] = torch.stack([row[name] for row in series]).cpu().numpy()
    return out
