"""Reading a ``torch.profiler`` trace of the profiled window: device
operations (kernels, copies, sets) inside the host annotation
``portbench.window``, their union (the busy time), the time by operation
name and the idle gaps, each named by what the host was doing when it
began: the innermost ``portbench.*`` span and the innermost other host
event on the thread that opened the window."""
from collections import defaultdict

DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')
WINDOW = 'portbench.window'


class TraceSummary:
    """Device time of the profiled window."""

    def __init__(self, window_s, busy_s, n_ops, by_name, idle_by_host):
        self.window_s = window_s
        self.busy_s = busy_s
        self.n_ops = n_ops
        self.by_name = by_name            # name -> [seconds, count]
        self.idle_by_host = idle_by_host  # host state -> seconds

    def kernel(self, part):
        """(seconds, launches) of the device operations whose name
        contains ``part``, or None."""
        secs, n = 0., 0
        for name, (s, c) in self.by_name.items():
            if part in name:
                secs += s
                n += c
        return (secs, n) if n else None

    def breakdown(self, top=10):
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[k, v[0]] for k, v in ops],
                'idle_gaps': [[k, v] for k, v in gaps]}


def _kind(e):
    """The activity kind of a trace event: ``activity_type()`` where the
    event has it, else told from its device and name (device events of a
    ``record_function`` carry its name)."""
    try:
        return e.activity_type()
    except AttributeError:
        pass
    name = e.name()
    if not _on_device(e):
        return 'user_annotation' if name.startswith('portbench.') \
            else 'cpu_op'
    if name.startswith('portbench.'):
        return 'gpu_user_annotation'
    if name.startswith('Memcpy'):
        return 'gpu_memcpy'
    if name.startswith('Memset'):
        return 'gpu_memset'
    return 'kernel'


def _on_device(e):
    return str(e.device_type()).endswith('CUDA')


def _host_names(host, times):
    """For each sorted time, (innermost portbench span, innermost other
    event) among the well-nested host intervals ``host`` (start, end,
    name), sorted by (start, -end)."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        span = next((e[2] for e in reversed(stack)
                     if e[2].startswith('portbench.')), 'portbench.none')
        op = next((e[2] for e in reversed(stack)
                   if not e[2].startswith('portbench.')), 'python')
        out.append(f'{span[len("portbench."):]}/{op}')
    return out


def summarize(prof):
    """The TraceSummary of a finished profiler, or None where the trace
    holds no window or no device operation in it."""
    events = prof.profiler.kineto_results.events()
    win = None
    for e in events:
        if e.name() == WINDOW and not _on_device(e):
            win = (e.start_ns(), e.end_ns(), e.start_thread_id())
    if win is None:
        return None
    w0, w1, tid = win
    dev, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1:
            continue
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            dev.append((max(s, w0), min(t, w1), e.name()))
        elif (not _on_device(e) and e.start_thread_id() == tid
              and e.name() != WINDOW):
            host.append((s, t, e.name()))
    if not dev:
        return None
    dev.sort()
    host.sort(key=lambda e: (e[0], -e[1]))
    by_name = defaultdict(lambda: [0., 0])
    for s, t, name in dev:
        by_name[name][0] += (t - s) * 1e-9
        by_name[name][1] += 1
    busy, gaps = 0, []
    cur_s, cur_e = w0, w0
    for s, t, _ in dev:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    idle = defaultdict(float)
    for (g0, g1), name in zip(gaps, _host_names(host, [g[0] for g in gaps])):
        idle[name] += (g1 - g0) * 1e-9
    return TraceSummary((w1 - w0) * 1e-9, busy * 1e-9, len(dev),
                        dict(by_name), dict(idle))
