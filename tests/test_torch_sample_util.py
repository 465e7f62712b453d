"""The port's sampling-script helpers (``utils/sample_util.py``): the cases
of tests/test_sample_util.py, and each helper against the JAX package's on
the same inputs.

``overlap_device_host`` is the pipeline behind ``image_sample``: batch k's
host work runs after batch k + 1 is queued on the card, and every result is
processed once, in order.
"""

import pytest

from guided_diffusion_clip_tpu.utils import sample_util as J
from guided_diffusion_clip_tpu_torch.utils.sample_util import add_delta_imgimg, overlap_device_host, process1


class TestOverlapDeviceHost:
    def test_processes_all_in_order(self):
        out = []
        overlap_device_host(iter(range(5)), out.append)
        assert out == [0, 1, 2, 3, 4]

    def test_empty_iterator(self):
        out = []
        overlap_device_host(iter(()), out.append)
        assert out == []

    def test_single_item(self):
        out = []
        overlap_device_host(iter([7]), out.append)
        assert out == [7]

    def test_overlap_depth_one(self):
        events = []

        def dispatched():
            for i in range(3):
                events.append(("dispatch", i))
                yield i

        overlap_device_host(dispatched(), lambda i: events.append(("process", i)))
        assert events == [("dispatch", 0), ("dispatch", 1), ("process", 0), ("dispatch", 2), ("process", 1),
                          ("process", 2)]

    def test_exception_in_dispatch_does_not_double_process(self):
        out = []

        def dispatched():
            yield 0
            yield 1
            raise RuntimeError("loader died")

        with pytest.raises(RuntimeError, match="loader died"):
            overlap_device_host(dispatched(), out.append)
        assert out == [0]  # item 1 was in flight; nothing processed twice

    @pytest.mark.parametrize("n", [0, 1, 4])
    def test_same_order_of_events_as_jax(self, n):
        def trace(fn):
            events = []

            def dispatched():
                for i in range(n):
                    events.append(("dispatch", i))
                    yield i

            fn(dispatched(), lambda i: events.append(("process", i)))
            return events

        assert trace(overlap_device_host) == trace(J.overlap_device_host)


class TestAddDeltaImgimg:
    def test_clip_feat2_defaults_to_clip_feat(self):
        assert add_delta_imgimg({"clip_feat": "A"})["clip_feat2"] == "A"

    def test_existing_clip_feat2_kept(self):
        assert add_delta_imgimg({"clip_feat": "A", "clip_feat2": "B"})["clip_feat2"] == "B"

    def test_input_not_mutated(self):
        src = {"clip_feat": "A"}
        add_delta_imgimg(src)
        assert "clip_feat2" not in src

    @pytest.mark.parametrize("kw", [{}, {"y": 3}, {"clip_feat": "A", "img2": "I"}, {"clip_feat": "A", "clip_feat2": "B"}])
    def test_matches_jax(self, kw):
        assert add_delta_imgimg(kw) == J.add_delta_imgimg(kw)
        assert process1(kw) == J.process1(kw)
