"""The port's many-device and many-process paths (hibag_tpu_torch.parallel
.mesh, predict(mesh=/devices=), train_parallel(mesh=), train_distributed,
train_dynamic, predict_distributed) on the CPU, held against the port on one
device and against hibag_tpu (whose mesh is conftest.py's 8 virtual CPU
devices) on the same seeded synthetic inputs. A mesh of the port repeats
the CPU device; two processes join a gloo group through
tests/_torch_dist_worker.py."""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import hibag_tpu
import hibag_tpu_torch
from hibag_tpu.parallel import mesh as jmesh
from hibag_tpu_torch.models import predict as port_predict
from hibag_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: seconds a worker pair may take (each finishes in about 10 here)
PAIR_TIMEOUT = 120


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _jax_geno(geno):
    return hibag_tpu.SNPGenoData(
        genotype=geno.genotype, sample_id=geno.sample_id, snp_id=geno.snp_id,
        snp_position=geno.snp_position, snp_allele=geno.snp_allele,
        assembly=geno.assembly)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(port model, hibag_tpu model, port geno, hibag_tpu geno): 42
    classifiers, divisible by neither 2, 3 nor 8; hibag_tpu's model is the
    port's through .npz."""
    model, geno = worker.model_and_cohort()
    path = str(tmp_path_factory.mktemp("m") / "model.npz")
    model.save(path)
    return model, hibag_tpu.AttrBagModel.load(path), geno, _jax_geno(geno)


@pytest.fixture(scope="module")
def panel():
    table, geno = worker.panel()
    jtable = hibag_tpu.HLATypeTable.from_alleles(
        table.sample_id, table.allele1, table.allele2, locus=table.locus)
    return (table, geno), (jtable, _jax_geno(geno))


def _same_classifiers(got, want, freq_rtol=None):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.snp_index, b.snp_index)
        np.testing.assert_array_equal(a.hap_bits, b.hap_bits)
        np.testing.assert_array_equal(a.hap_allele, b.hap_allele)
        assert a.oob_accuracy == b.oob_accuracy
        if freq_rtol is None:
            np.testing.assert_array_equal(a.hap_freq, b.hap_freq)
        else:
            np.testing.assert_allclose(a.hap_freq, b.hap_freq,
                                       rtol=freq_rtol)


# ---------------------------------------------------------------------------
# device lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nproc", [1, 2, 3, 4, 5])
def test_ranges_match_hibag_tpu(nproc):
    for n in range(41):
        for pi in range(nproc):
            assert tmesh.classifier_range(n, pi, nproc) == \
                jmesh.classifier_range(n, pi, nproc)
            assert tmesh.sample_range(n, pi, nproc) == \
                jmesh.sample_range(n, pi, nproc)
        assert [k for pi in range(nproc)
                for k in tmesh.classifier_range(n, pi, nproc)] == \
            list(range(n))


def test_ensemble_mesh_needs_a_card():
    """No CPU fallback: ensemble_mesh() and a process's "cuda" raise
    without a card, and an empty or malformed mesh raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.ensemble_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.ensemble_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.process_device("cuda", 1)
    with pytest.raises(ValueError, match="at least one"):
        tmesh.ensemble_mesh([])
    with pytest.raises(TypeError, match="list of devices"):
        tmesh.ensemble_mesh("cpu")
    assert tmesh.process_device("cpu", 3) == torch.device("cpu")
    assert tmesh.distributed_init() == (0, 1)


def test_shards_are_uneven_ranges_and_empty_ones_drop():
    mesh = tmesh.ensemble_mesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.axis_names == ("ens",)
    x = np.arange(8 * 2).reshape(8, 2)
    shards = tmesh.shard_ensemble(mesh, (x, {"y": x[:, 0]}))
    assert [s[0].shape[0] for s in shards] == [3, 3, 2]
    np.testing.assert_array_equal(torch.cat([s[0] for s in shards]).numpy(),
                                  x)
    np.testing.assert_array_equal(
        torch.cat([s[1]["y"] for s in shards]).numpy(), x[:, 0])
    assert [(lo, hi) for _, lo, hi in tmesh.shard_bounds(mesh, 2)] == \
        [(0, 1), (1, 2)]
    assert len(tmesh.shard_ensemble(mesh, x[:2])) == 2
    reps = tmesh.replicate(mesh, (x,))
    assert len(reps) == 3 and reps[0][0] is reps[2][0]
    with pytest.raises(ValueError, match="leading"):
        tmesh.shard_ensemble(mesh, (x, x[:3]))


# ---------------------------------------------------------------------------
# prediction over a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_results(case):
    """hibag_tpu's predict(mesh=ensemble_mesh()) over its 8 virtual
    devices, per engine and vote."""
    _, jmodel, _, jgeno = case
    mesh = jmesh.ensemble_mesh()
    assert mesh.size == len(jax.devices())
    return {(engine, vote): hibag_tpu.predict(
        jmodel, jgeno, mesh=mesh, engine=engine, vote=vote,
        with_prob=vote == "prob")
        for engine in ("pallas", "jnp") for vote in ("prob", "majority")}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("engine", ["pallas", "jnp"])
@pytest.mark.parametrize("vote", ["prob", "majority"])
def test_predict_mesh_matches_one_device_and_hibag_tpu(case, jax_mesh_results,
                                                       k, engine, vote):
    """Calls equal the port's on one device and hibag_tpu's on its mesh;
    postprob and matching at rtol 2e-4, atol 1e-6."""
    model, _, geno, _ = case
    prob = vote == "prob"
    base = hibag_tpu_torch.predict(model, geno, device="cpu", engine=engine,
                                   vote=vote, with_prob=prob)
    got = hibag_tpu_torch.predict(model, geno, devices=["cpu"] * k,
                                  engine=engine, vote=vote, with_prob=prob)
    want = jax_mesh_results[(engine, vote)]
    for ref in (base, want):
        np.testing.assert_array_equal(got.allele1, ref.allele1)
        np.testing.assert_array_equal(got.allele2, ref.allele2)
        np.testing.assert_allclose(got.matching, ref.matching, rtol=2e-4)
        np.testing.assert_allclose(got.prob, ref.prob, rtol=2e-4, atol=1e-6)
        if prob:
            np.testing.assert_allclose(got.postprob, ref.postprob, rtol=2e-4,
                                       atol=1e-6)
    # the LSE and the weights are one device's, in classifier order
    np.testing.assert_array_equal(got.matching, base.matching)
    again = hibag_tpu_torch.predict(model, geno, mesh=["cpu"] * k,
                                    engine=engine, vote=vote, with_prob=prob)
    np.testing.assert_array_equal(again.prob, got.prob)
    if prob:
        np.testing.assert_array_equal(again.postprob, got.postprob)


def test_predict_mesh_float64_raises(case):
    model, _, geno, _ = case
    with pytest.raises(ValueError, match="single-device"):
        hibag_tpu_torch.predict(model, geno, devices=["cpu", "cpu"],
                                dtype=np.float64)


def test_sharded_predict_matches_hibag_tpu(case):
    model, jmodel, geno, jgeno = case
    A = model.n_alleles
    codes, _ = hibag_tpu_torch.align_to_model(model, geno)
    packed = model.pack()
    tree = (packed.hap_bits, packed.hap_freq, packed.hap_allele,
            packed.snp_index)
    reps = (packed.snp_weight.astype(np.int32), codes)
    mesh = tmesh.ensemble_mesh(["cpu"] * 3)
    ens, wsum = tmesh.sharded_predict(mesh, tmesh.shard_ensemble(mesh, tree),
                                      tmesh.replicate(mesh, reps), A)
    # hibag_tpu's takes a classifier count the mesh divides
    jm = jmesh.ensemble_mesh(jax.devices()[:2])
    jtree = jmesh.shard_ensemble(jm, tree)
    jens, jwsum = jmesh.sharded_predict(*jtree,
                                        *jmesh.replicate(jm, reps), A)
    np.testing.assert_allclose(ens.numpy(), np.asarray(jens), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(jwsum), rtol=1e-6)
    res = hibag_tpu_torch.predict(model, geno, device="cpu", with_prob=True)
    iu, ju = np.triu_indices(A)
    np.testing.assert_allclose(ens.numpy()[:, iu, ju].T, res.postprob,
                               rtol=2e-4, atol=1e-6)


def test_predict_mesh_memo_uploads_once(case, monkeypatch):
    """A second predict(mesh=) builds and uploads no shard of the
    ensemble: each is memoised per (pack, device, classifier range)."""
    model, _, geno, _ = case
    model = model.subset_classifiers(16)
    built = []
    orig = port_predict.ensemble_from_packed

    def spy(packed, device, c0=0, c1=None):
        built.append((c0, c1))
        return orig(packed, device, c0, c1)

    monkeypatch.setattr(port_predict, "ensemble_from_packed", spy)
    hibag_tpu_torch.predict(model, geno, devices=["cpu", "cpu"])
    assert built == [(0, 8), (8, 16)]
    hibag_tpu_torch.predict(model, geno, devices=["cpu", "cpu"])
    assert len(built) == 2


# ---------------------------------------------------------------------------
# training over a mesh
# ---------------------------------------------------------------------------

def test_train_host_mesh_matches_one_device_and_hibag_tpu(panel):
    """train_parallel(mode="host", mesh=["cpu", "cpu"]) of 5 classifiers in
    one batch (shards of 3 and 2) equals the unsharded port bitwise, and
    hibag_tpu's host training in SNPs, haplotypes and OOB exactly,
    frequencies at rtol 1e-5 (its mesh takes no batch of 5 over 2
    devices)."""
    (table, geno), (jtable, jgeno) = panel
    kw = dict(n_classifiers=5, seed=100, batch=5, verbose=False,
              with_matching=False, mode="host")
    got = hibag_tpu_torch.train_parallel(table, geno, mesh=["cpu", "cpu"],
                                         **kw)
    base = hibag_tpu_torch.train_parallel(table, geno, device="cpu", **kw)
    _same_classifiers(got.classifiers, base.classifiers)
    want = hibag_tpu.train_parallel(jtable, jgeno, **kw)
    _same_classifiers(got.classifiers, want.classifiers, freq_rtol=1e-5)


def test_train_fused_mesh_matches_one_device(panel):
    """mode="fused" on a 3-device mesh with the default batch (3: batches
    of 3 and 2, the second leaving a device idle) and freeze re-seats in
    each shard equals the unsharded fused run bitwise."""
    (table, geno), _ = panel
    kw = dict(n_classifiers=5, seed=100, verbose=False, with_matching=False,
              mode="fused", hcap=32, on_overflow="freeze")
    got = hibag_tpu_torch.train_parallel(table, geno, mesh=["cpu"] * 3, **kw)
    base = hibag_tpu_torch.train_parallel(table, geno, device="cpu", batch=5,
                                          **kw)
    _same_classifiers(got.classifiers, base.classifiers)
    assert max(c.n_haplo for c in got.classifiers) > 32


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------

def _run_pair(task, tmp_path, late=False):
    """Run the worker pair on `task`; returns (out.npz of each, work_dir)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    work = tmp_path / "claims"
    outs = [tmp_path / f"{task}{i}.npz" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "tests/_torch_dist_worker.py", task,
         f"127.0.0.1:{port}", "2", str(i), str(work), str(outs[i])]
        + (["late"] if i == 1 and late else []),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        logs = [p.communicate(timeout=PAIR_TIMEOUT)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [np.load(o, allow_pickle=True) for o in outs], work


def _loaded(d):
    return [(d[f"snp{k}"], d[f"bits{k}"], d[f"freq{k}"], d[f"allele{k}"],
             float(d[f"oob{k}"])) for k in range(int(d["n"]))]


def _as_tuples(model):
    return [(c.snp_index, c.hap_bits, c.hap_freq, c.hap_allele,
             c.oob_accuracy) for c in model.classifiers]


def _assert_tuples_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def single_process(panel):
    """The one-process models of the worker's training kwargs, by mode."""
    (table, geno), _ = panel
    return {mode: hibag_tpu_torch.train_parallel(
        table, geno, with_matching=False, **dict(worker.TRAIN_KW, **kw))
        for mode, kw in worker.MODE_KW.items()}


def test_train_distributed_single_process(panel, single_process):
    """One process, no coordinator: train_distributed is train_parallel."""
    (table, geno), _ = panel
    m = hibag_tpu_torch.train_distributed(table, geno, **worker.TRAIN_KW)
    _same_classifiers(m.classifiers, single_process["host"].classifiers)
    assert m.matching is None


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_train_distributed_two_processes(tmp_path, single_process, mode):
    outs, _ = _run_pair(f"train-{mode}", tmp_path)
    for d in outs:
        _assert_tuples_equal(_loaded(d), _as_tuples(single_process[mode]))


def test_train_dynamic_two_processes_late_joiner(tmp_path, single_process):
    """Process 1 starts claiming once process 0 has claimed a job: every
    one of the 4 jobs is claimed once, each process claims at least one,
    and both processes merge the single-process model."""
    outs, work = _run_pair("dynamic", tmp_path, late=True)
    claims = sorted(os.listdir(work))
    assert claims == [f"claim_{i}" for i in range(4)]
    assert (work / "claim_0").read_text() == "0"
    assert {(work / c).read_text() for c in claims} == {"0", "1"}
    for d in outs:
        _assert_tuples_equal(_loaded(d), _as_tuples(single_process["host"]))


def test_predict_distributed_two_processes(tmp_path, case):
    model, _, geno, _ = case
    ref = hibag_tpu_torch.predict(model, geno, device="cpu", with_prob=True)
    outs, _ = _run_pair("predict", tmp_path)
    for d in outs:
        assert list(d["sample_id"]) == [str(s) for s in ref.sample_id]
        np.testing.assert_array_equal(d["allele1"], ref.allele1.astype(str))
        np.testing.assert_array_equal(d["allele2"], ref.allele2.astype(str))
        np.testing.assert_allclose(d["prob"], ref.prob, rtol=2e-4)
        np.testing.assert_allclose(d["matching"], ref.matching, rtol=2e-4)
        np.testing.assert_allclose(d["postprob"], ref.postprob, rtol=2e-4,
                                   atol=1e-6)


def test_gather_classifiers_two_processes(tmp_path):
    """A 100-classifier ensemble, 50 made in each process from their ids,
    gathers exactly and in order in both."""
    outs, _ = _run_pair("gather", tmp_path)
    want = [worker.gather_classifier(k) for k in range(worker.N_GATHER)]
    for d in outs:
        _assert_tuples_equal(_loaded(d), _as_tuples(
            worker.gather_model(want)))


def test_launch_counts_under_threads():
    """The kernels' launch counters lose no update when many threads
    count at once, as a mesh's shards do on cards: 16 threads x 2,000
    counts each, with the interpreter switching threads every microsecond."""
    from concurrent.futures import ThreadPoolExecutor

    from hibag_tpu_torch.ops import ens_acc, post_scores
    from hibag_tpu_torch.ops import train_step as ts

    n_threads, n = 16, 2000
    saved = (ens_acc.LAUNCHES, post_scores.LAUNCHES, dict(ts.LAUNCHES))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ens_acc.LAUNCHES = post_scores.LAUNCHES = 0
        ts.LAUNCHES["em_estep"] = 0

        def work():
            for _ in range(n):
                ens_acc._count()
                post_scores._count()
                ts._count("em_estep")

        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            futures = [pool.submit(work) for _ in range(n_threads)]
        for f in futures:
            f.result(timeout=60)
        assert ens_acc.LAUNCHES == post_scores.LAUNCHES == \
            ts.LAUNCHES["em_estep"] == n_threads * n
    finally:
        sys.setswitchinterval(switch)
        ens_acc.LAUNCHES, post_scores.LAUNCHES = saved[:2]
        ts.LAUNCHES.update(saved[2])


def test_a_mesh_is_all_cards_or_all_cpu():
    with pytest.raises(ValueError, match="all cards or all the CPU"):
        tmesh.ensemble_mesh(["cpu", "cuda:0"])
