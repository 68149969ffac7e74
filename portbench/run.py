"""Run one cell of BENCHMARK.json once, on the card it is started on.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, the CUDA context, the
kernels' nvcc build on a checkout's first run, the scene, the warm-up
calls) runs first and counts as ``setup_s``, from the process's start.
``--trace 0`` then calls the program for ``--seconds`` (a call that has
started when the time is up completes) and reports the cell's
end-to-end metrics; ``--trace 1`` calls it the traffic's ``trace_calls``
times untraced, then the same calls under ``torch.profiler`` with the
card's activity alone, then again with the host's ops recorded too
(``portbench/trace.py``), and reports its per-layer metrics, the device's
busy seconds and a breakdown.  Either way the window's calls
are sampled from the seed, the program's state is freed, and the plain
reference renders the sampled calls again: ``correct`` says whether
every number compared is within its limit.  The last line of standard
output is the result as one JSON object; the numbers compared, with
their limits, are the last lines of standard error and the result's last
key.  Without a CUDA card (or with fewer than the cell asks for) the run
exits non-zero and prints no result.
"""

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux: its start time in
    clock ticks since boot against the boot clock)."""
    with open('/proc/self/stat') as f:
        ticks = int(f.read().rsplit(')', 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - ticks / os.sysconf('SC_CLK_TCK'))


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import manifest  # noqa: E402
from portbench import trace as trace_mod  # noqa: E402
from portbench.metrics import reader  # noqa: E402

# top-level module names that the process may not hold once the window has
# closed: JAX and the JAX package (compared whole: the port's own name
# starts with the JAX package's)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'corona13_tpu')


def forbidden_modules() -> list[str]:
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name, power limit and SM clocks by nvidia-smi."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,'
             'clocks.max.sm', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f'nvidia-smi unavailable ({e})'
    return out.splitlines()[0] if out else 'nvidia-smi gave nothing'


def host_line() -> str:
    """The host's CPUs, their mean clock now and its load average: the
    host dispatches every launch, so its pace is the frame's."""
    try:
        with open('/proc/cpuinfo') as f:
            mhz = [float(l.split(':')[1]) for l in f if l.startswith('cpu MHz')]
        with open('/proc/loadavg') as f:
            load = ' '.join(f.read().split()[:3])
    except OSError as e:
        return f'host unreadable ({e})'
    mean = sum(mhz) / len(mhz) if mhz else float('nan')
    return f'{os.cpu_count()} cpus, mean {mean:.0f} MHz, load {load}'


class Reservoir:
    """``k`` items drawn uniformly from a stream, by a seeded generator."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device='cuda', size=None, t_start: float = T_START):
    """One run of a cell; returns the result object.  ``size`` (width,
    height) replaces the configuration's frame, for the tests on the CPU.
    A call that raises ends the run with no result, so ``failed`` is 0."""
    c = manifest.cell(workload)
    traffic = c['traffic']
    device = torch.device(device)
    drv = manifest.driver(traffic)(c['config'], traffic, seed, device,
                                   manifest.ROOT, size)
    drv.setup()
    drv.warm()
    _sync(device)
    sample = Reservoir(traffic.get('compare', 0), seed)
    times, seeds = [], []
    result = {}

    def call(k):
        a = time.perf_counter()
        out = drv.call(k)
        times.append(time.perf_counter() - a)
        sample.offer(out)
        seeds.append(out[0])

    if not traced:
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        end = t0 + seconds
        k = 0
        while time.perf_counter() < end:
            call(k)
            k += 1
        window_s = time.perf_counter() - t0
        metrics = dict(drv.end_to_end(times, window_s),
                       setup_s=(setup_s, 's'))
        want = [m['name'] for m in c['end_to_end']]
    else:
        from torch.profiler import ProfilerActivity, profile, record_function
        n = traffic['trace_calls']
        card = [ProfilerActivity.CUDA] if device.type == 'cuda' else []
        # the calls untraced: the host clock's seconds they take
        t0 = time.perf_counter()
        for k in range(n):
            call(k)
        _sync(device)
        wall_s = time.perf_counter() - t0
        # the same calls under the card's activity alone
        with profile(activities=card or [ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            for k in range(n):
                drv.call(k)
            _sync(device)
            window_s = time.perf_counter() - t0
        # and again with the host's ops recorded too
        with profile(activities=[ProfilerActivity.CPU] + card) as host_prof:
            t0 = time.perf_counter()
            for k in range(n):
                with record_function(trace_mod.SPAN):
                    drv.call(k)
            _sync(device)
            host_s = time.perf_counter() - t0
        print(f'traced window: {n} calls, seconds a call: {wall_s / n!r} '
              f'untraced, {window_s / n!r} with the card traced, '
              f'{host_s / n!r} with the host traced too', file=sys.stderr,
              flush=True)
        window = trace_mod.Window(prof, n, window_s, wall_s,
                                  trace_mod.HostPass(host_prof),
                                  drv.trace_extra(seeds[0]))
        metrics, want = {}, []
        for m in c['per_layer']:
            want.append(m['name'])
            value = reader(m['name'])(window)
            if value is not None:
                metrics[m['name']] = (value, m['unit'])
        result['breakdown'] = window.breakdown()
        drv.notes(seeds[0])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    missing = [n for n in want if n not in metrics]
    if missing and not traced:      # a per-layer reader may find nothing
        raise RuntimeError(f'{workload}: no reading of {missing}')
    units = {m['name']: m['unit'] for m in c['end_to_end'] + c['per_layer']}
    dev = dict(platform='gpu' if device.type == 'cuda' else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == 'cuda' else 'cpu'),
               count=c['workload']['chips'], memory_peak_bytes=peak)
    if traced:
        dev.update(busy_s=window.busy_s, window_s=window.window_s)
    attempted = len(seeds)
    samples = sample.items
    drv.release()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    checks = drv.check(samples)
    correct = all(v <= lim for v, lim in checks.values())   # NaN: False
    return dict(
        correct=correct, attempted=attempted, failed=0,
        metrics={n: {'value': metrics[n][0], 'unit': units[n]}
                 for n in want if n in metrics},
        device=dev, **result,
        checks={n: {'value': v, 'limit': lim}
                for n, (v, lim) in checks.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = manifest.cell(args.workload)['workload']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: {args.workload} needs {chips} CUDA card(s); '
              f'torch sees {torch.cuda.device_count()}: no result',
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(f'card: {card_line()}; host: {host_line()}; torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}', file=sys.stderr,
          flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f'portbench: the process holds {found} after the window: no '
              f'result', file=sys.stderr)
        return 3
    m = result['metrics']
    print('metrics: ' + ', '.join(f"{k} {v['value']!r} {v['unit']}"
                                  for k, v in m.items())
          + f"; peak {result['device']['memory_peak_bytes']} B; card "
          f"{card_line()}; host {host_line()}", file=sys.stderr)
    for name, v in result['checks'].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
