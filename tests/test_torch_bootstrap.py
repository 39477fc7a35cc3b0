"""The port's runtime bootstrap (tf_operator_tpu_torch.runtime.bootstrap):
its copies of SliceInfo / slice_info_from_env / global_rendezvous equal
the JAX package's over single-host, multi-host and multislice TPUJob
envs; the rendezvous it builds from either contract (PyTorchJob,
TPUJob); the refusal that names a missing variable; and a real
two-replica PyTorchJob under the local executor whose containers run
train_llama --smoke straight from the operator-injected env."""
import dataclasses
import os
import sys

import pytest
import torch.distributed as dist

from tests import testutil
from tf_operator_tpu.runtime import bootstrap as jb
from tf_operator_tpu.runtime.local import run_local
from tf_operator_tpu_torch.runtime import bootstrap as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENVS = {
    "single-host": {},
    "multi-host": {"COORDINATOR_ADDRESS": "job-worker-0.job:8476",
                   "NUM_PROCESSES": "4", "PROCESS_ID": "2",
                   "TPU_WORKER_ID": "2", "TPU_ACCELERATOR_TYPE": "v5p-32",
                   "TPU_WORKER_HOSTNAMES": "h0,h1,h2,h3",
                   "TPU_TOPOLOGY": "2x2x4"},
    "multislice": {"COORDINATOR_ADDRESS": "job-s1-0.job:8476",
                   "MEGASCALE_COORDINATOR_ADDRESS": "job-s0-0.job:8080",
                   "NUM_PROCESSES": "2", "PROCESS_ID": "1",
                   "TPU_SLICE_ID": "1", "TPU_NUM_SLICES": "2",
                   "TPU_HOSTS_PER_SLICE": "2", "TPU_TOTAL_HOSTS": "4",
                   "TPU_WORKER_HOSTNAMES": "a,b"},
    "multislice-megascale-count": {
        "MEGASCALE_COORDINATOR_ADDRESS": "job-s0-0.job:8080",
        "MEGASCALE_NUM_SLICES": "3", "TPU_SLICE_ID": "2",
        "TPU_HOSTS_PER_SLICE": "1", "TPU_TOTAL_HOSTS": "3"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_slice_info_and_rendezvous_equal_jax(name):
    env = ENVS[name]
    got, want = tb.slice_info_from_env(env), jb.slice_info_from_env(env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_distributed == want.is_distributed
    assert tb.global_rendezvous(got) == jb.global_rendezvous(want)


@pytest.mark.parametrize("env,want", [
    ({}, (None, 1, 0)),
    ({"WORLD_SIZE": "1"}, (None, 1, 0)),
    ({"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "10.0.0.1",
      "MASTER_PORT": "23456"}, ("tcp://10.0.0.1:23456", 2, 1)),
    (ENVS["multi-host"], ("tcp://job-worker-0.job:8476", 4, 2)),
    (ENVS["multislice"], ("tcp://job-s0-0.job:8080", 4, 3)),
])
def test_rendezvous_reads_either_contract(env, want):
    assert tb.rendezvous(env) == want


@pytest.mark.parametrize("env,missing", [
    ({"WORLD_SIZE": "2"}, "MASTER_ADDR"),
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "a"}, "MASTER_PORT"),
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "a", "MASTER_PORT": "1"}, "RANK"),
    ({"NUM_PROCESSES": "2"}, "COORDINATOR_ADDRESS"),
    ({"TPU_NUM_SLICES": "2", "COORDINATOR_ADDRESS": "c:1"},
     "MEGASCALE_COORDINATOR_ADDRESS"),
])
def test_a_missing_variable_is_named(env, missing):
    with pytest.raises(ValueError, match=rf"needs {missing} "):
        tb.initialize(env, device="cpu")
    assert not dist.is_initialized()


def test_one_process_initializes_nothing():
    job = tb.initialize({"WORLD_SIZE": "1", "RANK": "0"}, device="cpu")
    assert (job.rank, job.world, job.backend, str(job.device)) == \
        (0, 1, None, "cpu")
    assert not dist.is_initialized()
    assert tb.initialize({}, device="cpu").slice == tb.SliceInfo()


def _replica(n, port, argv):
    return {"replicas": n, "restartPolicy": "Never",
            "template": {"spec": {"containers": [{
                "name": "pytorch", "image": "local",
                "command": [sys.executable, "-u", "-m"] + argv,
                "ports": [{"name": "pytorchjob-port",
                           "containerPort": port}]}]}}}


def test_pytorchjob_replicas_train_from_the_injected_env():
    """A PyTorchJob of a master and a worker under the local executor:
    each container runs train_llama --smoke on the CPU, bootstraps from
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK over gloo, and both
    report the same global loss."""
    port = testutil.free_port()
    argv = ["tf_operator_tpu_torch.train_llama", "--smoke", "--device",
            "cpu", "--steps", "2", "--per-host-batch", "2", "--seq-len",
            "16"]
    result = run_local({
        "apiVersion": "kubeflow.org/v1", "kind": "PyTorchJob",
        "metadata": {"name": "torchdp", "namespace": "default"},
        "spec": {"pytorchReplicaSpecs": {
            "Master": _replica(1, port, argv),
            "Worker": _replica(1, port, argv)}},
    }, timeout=120.0, extra_env={"PYTHONPATH": REPO,
                                 "OMP_NUM_THREADS": "1"})
    logs = "\n".join(f"--- {k}\n{v}"
                     for k, v in sorted(result["logs"].items()))
    assert result["state"] == "Succeeded", f"{result['state']}\n{logs}"
    assert "host 0/2" in logs and "host 1/2" in logs, logs
    done = sorted(line for line in logs.splitlines()
                  if line.startswith("complete: steps=2"))
    assert len(done) == 2 and done[0] == done[1], logs
