"""The reduction of a profiler trace: the card's busy time leaves out the
annotations' spans on it, and idle gaps are named by the host op that
covered them."""

from torch.autograd import DeviceType

from benchmark import trace


class _Ev:
    def __init__(self, name, dev, start, dur, index=0):
        self._v = (name, dev, start, dur, index)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_index(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_summarize_busy_idle_and_names():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        _Ev("ckks.rotate", cpu, 0, 600),
        _Ev("aten::mul", cpu, 100, 50),
        _Ev("ckks.rescale", cpu, 700, 300),
        _Ev("ckks.rotate", cuda, 0, 1000),          # annotation on the card
        _Ev("col_pass", cuda, 200, 100),
        _Ev("elementwise_kernel<long>", cuda, 250, 150),
        _Ev("chunk_pass", cuda, 800, 100),
        _Ev("elementwise_kernel<long>", cuda, 100, 400, index=1),
    ]
    t = trace.summarize(_Prof(events), 0, 1000)
    assert t["window_s"] == 1e-6
    card = t["cards"][0]
    assert abs(card["busy_s"] - 300e-9) < 1e-15       # [200, 400], [800, 900]
    assert "ckks.rotate" not in card["ops"]
    assert abs(t["cards"][1]["busy_s"] - 400e-9) < 1e-15
    idle = dict(t["idle_gaps"])
    # card 0: [0, 200) and [400, 800) under rotate (midpoints 100, 600:
    # 600 is rotate's end), [900, 1000) under rescale; card 1: [0, 100)
    # under rotate, [500, 1000) under rescale (midpoint 750)
    assert abs(idle["ckks.rotate"] - 700e-9) < 1e-15
    assert abs(idle["ckks.rescale"] - 600e-9) < 1e-15
    assert trace.is_ntt("col_pass") and not trace.is_ntt("gather")
