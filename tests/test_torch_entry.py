"""The port's entry points (entry.py) on the CPU: ``entry(device="cpu")``'s
step returns the tensors that ``DeviceClassifier._device_phase`` computes
for the same batch (bit for bit), and ``dryrun_multichip(8,
device="cpu")`` holds a (4, 2) MeshClassifier byte-equal to the single
device on its synthetic corpus."""
import torch


def test_entry_step_equals_device_phase():
    from desamba_tpu_torch.engine.device.classifier import DeviceClassifier
    from desamba_tpu_torch.entry import entry, synthetic_corpus

    idx, recs = synthetic_corpus()
    clf = DeviceClassifier(idx, None, "cpu")
    seen = []
    orig = clf._device_step

    def spy(batch, prep=None):
        step = orig(batch, prep)
        seen.append(step.tensors)
        return step

    clf._device_step = spy
    res = clf._device_phase(recs)()
    assert sum(1 for r in res if r.chains) >= 10
    exp = seen[0]
    assert {"chains", "fb", "reason", "n", "over"} <= set(exp)

    step, args = entry(device="cpu")
    assert [r.seq for r in args[0]] == [r.seq for r in recs]
    got = step(*args)
    assert sorted(got) == sorted(exp)
    for k, t in exp.items():
        assert got[k].device.type == "cpu"
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    # on a given classifier and batch, the step is that classifier's
    step2, args2 = entry(classifier=clf, recs=recs[:5])
    assert len(args2[0]) == 5
    assert step2(*args2)["chains"].shape[1:] == exp["chains"].shape[1:]


def test_dryrun_multichip_on_cpu_mesh(capsys):
    from desamba_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(8, device="cpu")
    assert (out["n_dp"], out["n_idx"], out["distinct_devices"]) == (4, 2, 1)
    assert out["classified"] >= 10 and out["slow_path"] > 0
    assert "dryrun_multichip ok" in capsys.readouterr().out
