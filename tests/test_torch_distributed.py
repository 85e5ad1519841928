"""The port's process-aware mesh and bootstrap: the cases of
tests/test_distributed.py with the same fake device records (the ``idx``
axis never crosses a process, ``dp`` spans them), and the multi-process
worker's walk over the slices' stream states, which re-runs exactly the
slices whose guessed seed lies on the other side of 510 from the serial
state, from a seed on the serial side."""
import pytest
import torch


class FakeDev:
    def __init__(self, pid, did):
        self.process_index = pid
        self.id = did

    def __repr__(self):
        return f"d{self.process_index}.{self.id}"


def test_host_mesh_keeps_idx_within_process():
    from desamba_tpu_torch.parallel.distributed import host_mesh

    devs = [FakeDev(p, p * 4 + i) for p in range(2) for i in range(4)]
    mesh = host_mesh(n_idx=4, devices=devs)
    assert mesh.devices.shape == (2, 4)
    for row in mesh.devices:
        assert len({d.process_index for d in row}) == 1

    mesh2 = host_mesh(n_idx=2, devices=devs)
    assert mesh2.devices.shape == (4, 2)
    for row in mesh2.devices:
        assert len({d.process_index for d in row}) == 1
    # dp-major order interleaves hosts' dp groups contiguously
    assert [d.process_index for d in mesh2.devices[:, 0]] == [0, 0, 1, 1]


def test_host_mesh_rejects_bad_split():
    from desamba_tpu_torch.parallel.distributed import host_mesh

    devs = [FakeDev(0, i) for i in range(4)]
    with pytest.raises(ValueError):
        host_mesh(n_idx=3, devices=devs)


def test_host_mesh_real_devices_single_process():
    """Four devices of this process (the CPU, repeated, as the JAX test's
    four virtual CPU devices), as ``global_devices`` records them."""
    from desamba_tpu_torch.parallel.distributed import (global_devices,
                                                        host_mesh)

    devs = global_devices([torch.device("cpu")] * 4)
    assert [(d.process_index, d.id, d.device) for d in devs] == [
        (0, k, "cpu") for k in range(4)]
    mesh = host_mesh(n_idx=2, devices=devs)
    assert mesh.axis_names == ("dp", "idx")
    assert mesh.devices.shape[1] == 2
    assert mesh.devices.size == len(devs) // 2 * 2


def test_initialize_noop_without_coordinator(monkeypatch):
    from desamba_tpu_torch.parallel import distributed

    monkeypatch.delenv("DESAMBA_COORDINATOR", raising=False)
    assert distributed.initialize() is False


def _stream_model(slices):
    """The serial run of slices of (read length, raises the state) pairs:
    each slice's serial entry state, the JAX worker's guess (the longest
    read before it) and, for any seed, the slice's final state and the
    side of 510 it is filtered on."""
    serial, guess, state, longest = [], [], 0, 0
    for s in slices:
        serial.append(state)
        guess.append(longest)
        for n, raises in s:
            if raises:
                state = max(state, n)
            longest = max(longest, n)

    def run(j, seed):
        st = seed
        for n, raises in slices[j]:
            if raises:
                st = max(st, n)
        return st

    return serial, guess, run


@pytest.mark.parametrize("slices,rerun", [
    # a chainless 600-bp read ends slice 0: slice 1's guess passes 510
    ([[(300, True), (600, False)], [(200, True), (700, True)],
      [(100, True)]], [1]),
    # the serial state crosses 510 inside slice 0: nothing to re-run
    ([[(520, True), (600, False)], [(200, True)], [(100, True)]], []),
    # two chainless long reads, slices 1 and 2 both re-run; slice 2's
    # re-run comes after slice 1's, whose raise stays below 510
    ([[(900, False)], [(400, True), (800, False)], [(100, True)],
      [(509, True), (510, True)], [(60, True)]], [1, 2, 3]),
    # slice 1 raises to exactly 510 from a guess below it
    ([[(300, True)], [(510, True)], [(100, True)]], []),
])
def test_serial_walk_reruns_across_the_split(slices, rerun):
    from desamba_tpu_torch.tools.multihost_worker import (STATE_SPLIT,
                                                          serial_walk)

    serial, guess, run = _stream_model(slices)
    finals = [run(j, g) for j, g in enumerate(guess)]
    redone = serial_walk(guess, finals, run)
    assert [j for j, _ in redone] == rerun
    # a re-run starts on the serial state's side, and no slice that kept
    # its guess was on the other side
    for j, seed in redone:
        assert (seed >= STATE_SPLIT) == (serial[j] >= STATE_SPLIT)
        assert seed <= serial[j]
    kept = set(range(len(slices))) - set(rerun)
    for j in kept:
        assert (guess[j] >= STATE_SPLIT) == (serial[j] >= STATE_SPLIT)
