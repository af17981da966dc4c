"""The port's core graph and device seam (``znicz_tpu_torch/core``): the
cases of tests/test_core.py run against the port — gates, ``Array``,
``prng``, the control chain, gate_skip/gate_block, the Repeater loop,
attribute links, the timing table — plus the ``Array`` map discipline on
``TorchDevice("cpu")`` (``put`` copies), the prng host streams against
the JAX package's for the same seed, the device classes and the
per-backend dispatch."""

import pickle

import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.backends import (AutoDevice, NumpyDevice,
                                           TorchDevice)
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array, roundup
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.plumbing import Repeater
from znicz_tpu_torch.core.units import TrivialUnit, Unit
from znicz_tpu_torch.core.workflow import Workflow


# -- mutable gates ----------------------------------------------------------

def test_bool_assignment_and_composites():
    complete = Bool(False)
    improved = Bool(True)
    gate = ~complete & improved
    assert bool(gate)
    complete <<= True
    assert not bool(gate)  # composite re-evaluates operands live
    blocked = complete | Bool(False)
    assert bool(blocked)
    with pytest.raises(ValueError):
        gate.set(True)


# -- memory -----------------------------------------------------------------

def test_roundup():
    assert roundup(5, 4) == 8 and roundup(8, 4) == 8


def test_array_map_semantics_numpy_device():
    arr = Array(np.arange(6, dtype=np.float32).reshape(2, 3))
    arr.initialize(NumpyDevice())
    assert arr.map_read()[1, 2] == 5.0
    arr.map_write()[0, 0] = 42.0
    assert arr.mem[0, 0] == 42.0


def test_array_device_roundtrip():
    dev = TorchDevice("cpu")
    arr = Array(np.ones((4, 4), dtype=np.float32))
    arr.initialize(dev)
    dv = arr.devmem
    assert isinstance(dv, torch.Tensor) and dv.shape == (4, 4)
    # a step output replacing the buffer
    arr.set_devmem(dv * 3.0)
    assert arr.map_read()[0, 0] == 3.0
    # host write flows back on next devmem access
    arr.map_write()[0, 0] = 7.0
    assert float(arr.devmem[0, 0]) == 7.0
    assert arr.dtype == np.float32 and arr.shape == (4, 4)


def test_array_put_and_map_read_copy():
    """The device buffer never aliases the host array on the CPU (the
    reason is the reference's, backends.py:95-102), and map_read hands
    back a host copy, never a view of the device buffer."""
    dev = TorchDevice("cpu")
    host = np.zeros(4, np.float32)
    put = dev.put(host)
    host[0] = 5.0
    assert float(put[0]) == 0.0
    arr = Array(np.zeros(3, np.float32))
    arr.initialize(dev)
    arr.mem[0] = 9.0            # a write without the map discipline ...
    assert float(arr.devmem[0]) == 0.0      # ... never reaches the device
    arr.set_devmem(torch.ones(3))
    read = arr.map_read()
    read[1] = -1.0
    assert float(arr.devmem[1]) == 1.0
    arr.map_invalidate()[2] = 4.0
    arr.unmap()
    assert arr.devmem.tolist() == [1.0, -1.0, 4.0]


def test_array_pickle_drops_device():
    arr = Array(np.full((2, 2), 5.0, np.float32))
    arr.initialize(TorchDevice("cpu"))
    arr.set_devmem(arr.devmem + 1)
    restored = pickle.loads(pickle.dumps(arr))
    assert restored.mem[0, 0] == 6.0 and restored.device is None


def test_array_devmem_before_initialize_raises():
    with pytest.raises(RuntimeError, match="initialize"):
        Array(np.zeros(2, np.float32)).devmem


# -- prng -------------------------------------------------------------------

def test_prng_determinism_and_state():
    gen = prng.get("t1")
    gen.seed(123)
    a = gen.uniform(-1, 1, (5,))
    state = gen.state_dict()
    b = gen.uniform(-1, 1, (5,))
    gen.load_state_dict(state)
    b2 = gen.uniform(-1, 1, (5,))
    np.testing.assert_array_equal(b, b2)
    gen.seed(123)
    np.testing.assert_array_equal(a, gen.uniform(-1, 1, (5,)))


def test_prng_keys_deterministic():
    gen = prng.get("t2")
    gen.seed(7)
    k1 = gen.key("cpu")
    gen.seed(7)
    k2 = gen.key("cpu")
    assert isinstance(k1, torch.Generator)
    assert torch.equal(torch.rand(4, generator=k1),
                       torch.rand(4, generator=k2))
    k3 = gen.key("cpu")                       # the counter moved on
    assert not torch.equal(torch.rand(4, generator=k3),
                           torch.rand(4, generator=k2))


def test_prng_host_streams_equal_the_jax_package():
    """One seed, both packages: the same named streams draw the same
    bits — the weights and shuffles of a port run are the reference's."""
    prng.seed_all(5)
    jprng.seed_all(5)
    for name in ("default", "synthetic", "t3"):
        ours, ref = prng.get(name), jprng.get(name)
        np.testing.assert_array_equal(ours.uniform(-1, 1, (7,)),
                                      ref.uniform(-1, 1, (7,)))
        np.testing.assert_array_equal(ours.normal(0, 2, (3, 4)),
                                      ref.normal(0, 2, (3, 4)))
        a, b = np.arange(20), np.arange(20)
        ours.shuffle(a)
        ref.shuffle(b)
        np.testing.assert_array_equal(a, b)
        assert ours.state_dict()["np_state"] == ref.state_dict()["np_state"]


# -- devices and dispatch -----------------------------------------------------

def test_torch_device_policy():
    dev = TorchDevice("cpu")
    assert dev.suffix == "torch" and dev.is_accelerated
    assert dev.compute_dtype == torch.float32   # f32 on the CPU always
    assert TorchDevice("cpu", precision="float32").compute_dtype == \
        torch.float32
    assert not NumpyDevice().is_accelerated


def test_default_devices_are_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDevice()
    saved = root.common.engine.backend
    try:
        root.common.engine.backend = "numpy"
        assert isinstance(AutoDevice(), NumpyDevice)
        for backend in ("torch", "auto"):
            root.common.engine.backend = backend
            with pytest.raises(RuntimeError, match="device='cpu'"):
                AutoDevice()
        root.common.engine.backend = "tpu"
        with pytest.raises(ValueError, match="backend"):
            AutoDevice()
    finally:
        root.common.engine.backend = saved


class _Dispatch(AcceleratedUnit):
    def __init__(self, workflow=None):
        super().__init__(workflow)
        self.ran = []

    def numpy_run(self):
        self.ran.append("numpy")


class _TorchDispatch(_Dispatch):
    def torch_run(self):
        self.ran.append("torch")


def test_accelerated_unit_dispatch_and_default_fallback():
    unit = _TorchDispatch()
    unit.initialize(device=TorchDevice("cpu"))
    unit.run()
    unit.initialize(device=NumpyDevice())
    unit.run()
    assert unit.ran == ["torch", "numpy"]
    # a unit without a torch path falls back to its numpy oracle
    plain = _Dispatch()
    plain.initialize(device=TorchDevice("cpu"))
    plain.run()
    assert plain.ran == ["numpy"] and plain.backend_suffix == "torch"
    plain.batch_size = None
    assert plain.current_batch_size(Array(np.zeros((3, 2)))) == 3


# -- unit graph -------------------------------------------------------------

class Recorder(Unit):
    """Appends its name to a shared trace on each run."""

    def __init__(self, workflow, trace, name):
        super().__init__(workflow, name=name)
        self.trace = trace

    def run(self):
        self.trace.append(self.name)


def test_control_chain_and_all_links_join():
    wf = Workflow(name="wf")
    trace = []
    a = Recorder(wf, trace, "a")
    b = Recorder(wf, trace, "b")
    c = Recorder(wf, trace, "c")  # fires only after BOTH a and b
    a.link_from(wf.start_point)
    b.link_from(wf.start_point)
    c.link_from(a)
    c.link_from(b)
    wf.end_point.link_from(c)
    wf.initialize(device=None)
    wf.run()
    assert trace == ["a", "b", "c"]
    assert wf.end_point.reached


def test_gate_skip_propagates_without_running():
    wf = Workflow(name="wf")
    trace = []
    a = Recorder(wf, trace, "a")
    b = Recorder(wf, trace, "b")
    a.link_from(wf.start_point)
    b.link_from(a)
    wf.end_point.link_from(b)
    a.gate_skip <<= True
    wf.initialize(device=None)
    wf.run()
    assert trace == ["b"]  # a skipped but signal propagated


def test_gate_block_stops_propagation():
    wf = Workflow(name="wf")
    trace = []
    a = Recorder(wf, trace, "a")
    a.link_from(wf.start_point)
    wf.end_point.link_from(a)
    a.gate_block <<= True
    wf.initialize(device=None)
    wf.run()
    assert trace == [] and not wf.end_point.reached


def test_repeater_loop_with_decision_gate():
    """Repeater -> work -> decision, looping back to the Repeater until
    `complete` flips, then end_point opens."""
    wf = Workflow(name="wf")
    trace = []

    class Decision(Unit):
        def __init__(self, workflow):
            super().__init__(workflow, name="decision")
            self.complete = Bool(False)
            self.n = 0

        def run(self):
            self.n += 1
            if self.n >= 3:
                self.complete <<= True

    rep = Repeater(wf)
    work = Recorder(wf, trace, "work")
    dec = Decision(wf)
    rep.link_from(wf.start_point)
    work.link_from(rep)
    dec.link_from(work)
    rep.link_from(dec)           # loop back-edge
    rep.gate_block = dec.complete
    wf.end_point.link_from(dec)
    wf.end_point.gate_block = ~dec.complete
    wf.initialize(device=None)
    wf.run()
    assert trace == ["work"] * 3
    assert wf.end_point.reached


def test_link_attrs_aliasing_two_way():
    wf = Workflow(name="wf")
    a = TrivialUnit(wf, name="a")
    b = TrivialUnit(wf, name="b")
    a.output = Array(np.zeros(3, np.float32))
    b.link_attrs(a, ("input", "output"))
    assert b.input is a.output
    a.output = Array(np.ones(3, np.float32))
    assert b.input is a.output  # live alias, not a snapshot
    b.input = Array(np.full(3, 2.0, np.float32))
    assert a.output.mem[0] == 2.0  # two-way write-back


def test_timing_table():
    wf = Workflow(name="wf")
    trace = []
    a = Recorder(wf, trace, "a")
    a.link_from(wf.start_point)
    wf.end_point.link_from(a)
    wf.initialize(device=None)
    wf.run()
    table = wf.timing_table()
    assert "a" in table and "runs" in table


def test_workflow_initializes_children_with_the_device():
    wf = Workflow(name="wf")
    unit = _TorchDispatch(wf)
    unit.link_from(wf.start_point)
    wf.end_point.link_from(unit)
    dev = TorchDevice("cpu")
    wf.initialize(device=dev)
    wf.run()
    assert unit.device is dev and unit.ran == ["torch"]
    with pytest.raises(RuntimeError, match="before initialize"):
        Workflow(name="cold").run()
