"""Which traversal form a kernel's name is: ``chip_smoke.py``
``_kernel_key`` (lines 2256-2276 as of commit 2084081), frozen here."""

from __future__ import annotations

import re


def kernel_key(name):
    """The entry of trace_cuda.launches that a traversal kernel's name (as
    the profiler demangles it) counts under, or None for another kernel."""
    if re.search(r'union_kernel<', name):
        return 'counters'
    m = re.search(r'(traverse|deep|skip|dense)_kernel<[^<>]*?(\w+)Leaf, '
                  r'(true|false)(?:, (true|false))?', name)
    if m is None:
        return None
    kernel, leaf, any_hit, counters = m.groups()
    mode = 'any' if any_hit == 'true' else 'closest'
    kind = {'Triangle': '', 'MovingTriangle': 'moving', 'Sphere': 'sphere',
            'Cone': 'line'}[leaf]
    if kernel == 'traverse' and counters == 'true':
        return f'{kind or "tri"}_counters'
    if kernel in ('deep', 'skip'):
        return f'{kernel}_{mode}'
    if kernel == 'dense':
        return f'dense_{kind}_{mode}'
    return f'{kind}_{mode}' if kind else mode
