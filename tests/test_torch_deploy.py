"""The port's H100 deployment (``tinydiffusionmodels_torch.deploy``,
``deployment/h100/``) with ``docker`` and ``gcloud`` stubbed, as
``tests/test_deployment.py`` tests the JAX package's: nothing is built or
submitted. Every job type has a config that requests NVIDIA H100 80GB
cards and runs a module of the port that exists, the multi-GPU jobs start
``torchrun`` over the cards they request, and the image copies the
package with its CUDA sources."""

from __future__ import annotations

import importlib.util
import json
from unittest.mock import MagicMock, patch

import pytest
import yaml

from tinydiffusionmodels_torch import deploy


def _spec(job: str) -> dict:
    return yaml.safe_load((deploy.CONFIG_DIR / f"{job}.yaml").read_text())


def test_job_types_cover_the_jax_packages():
    jax_jobs = ("shakespeare-training", "shakespeare-sampling",
                "mnist-training", "mnist-sampling", "shakespeare-training-sp",
                "shakespeare-training-quality")
    assert set(jax_jobs) <= set(deploy.JOB_TYPES)
    assert sorted(p.stem for p in deploy.CONFIG_DIR.glob("*.yaml")) == \
        sorted(deploy.JOB_TYPES)


@pytest.mark.parametrize("job", deploy.JOB_TYPES)
def test_config_requests_h100s_and_runs_a_port_module(job):
    spec = _spec(job)
    machine = spec["workerPoolSpecs"]["machineSpec"]
    assert machine["acceleratorType"] == "NVIDIA_H100_80GB"
    cards = machine["acceleratorCount"]
    assert machine["machineType"] == f"a3-highgpu-{cards}g"
    command = spec["workerPoolSpecs"]["containerSpec"]["command"]
    module = command[command.index("-m") + 1]
    assert module.startswith("tinydiffusionmodels_torch.")
    assert importlib.util.find_spec(module) is not None, module
    text = (deploy.CONFIG_DIR / f"{job}.yaml").read_text()
    if cards > 1:
        assert command[0] == "torchrun"
        assert command[command.index("--nproc_per_node") + 1] == str(cards)
        assert "--seq_parallel" in spec["workerPoolSpecs"]["containerSpec"][
            "args"]
        assert "NCCL at world > 1 is unverified" in text
    else:
        assert command[:2] == ["python", "-m"]
    assert "tinydiffusionmodels_tpu" not in text


def test_dockerfile_is_a_cuda_devel_image_with_the_csrc():
    text = deploy.DOCKERFILE.read_text()
    base = next(line for line in text.splitlines()
                if line.startswith("FROM "))
    assert "devel" in base and "cuda" in base
    assert "COPY tinydiffusionmodels_torch/ ./tinydiffusionmodels_torch/" \
        in text
    assert (deploy.REPO_ROOT / "tinydiffusionmodels_torch" / "csrc").is_dir()
    ignored = (deploy.REPO_ROOT / ".dockerignore").read_text().split()
    assert not any("csrc" in p or p.startswith("tinydiffusionmodels_torch")
                   for p in ignored)
    assert "tinydiffusionmodels_tpu" not in text


def test_build_uses_the_h100_dockerfile():
    with patch.object(deploy, "run",
                      return_value=MagicMock(returncode=0)) as mock_run:
        deploy.build_container("img")
    build, push = (c[0][0] for c in mock_run.call_args_list)
    assert build[:2] == ["docker", "build"]
    assert build[build.index("-f") + 1] == str(deploy.DOCKERFILE)
    assert build[-1] == str(deploy.REPO_ROOT)
    assert push == ["docker", "push", "img"]


def test_deploy_job_submits_its_config(capsys):
    reply = MagicMock(returncode=0, stdout=json.dumps(
        {"name": "projects/p/locations/r/customJobs/12345"}))
    with patch.object(deploy, "run", return_value=reply) as mock_run:
        job_id = deploy.deploy_job("shakespeare-training-sp", project="p",
                                   region="r", no_build=True,
                                   image_uri="img")
    assert job_id == "12345"
    cmd = mock_run.call_args[0][0]
    assert cmd[:4] == ["gcloud", "ai", "custom-jobs", "create"]
    assert f"--config={deploy.CONFIG_DIR / 'shakespeare-training-sp.yaml'}" \
        in cmd
    assert "python deployment/monitor.py 12345" in capsys.readouterr().out


def test_build_then_submit_and_failures_exit():
    ok = MagicMock(returncode=0, stdout="{}")
    with patch.object(deploy, "run", return_value=ok) as mock_run:
        assert deploy.deploy_job("mnist-training", project="p", region="r",
                                 no_build=False, image_uri="img") is None
    assert [c[0][0][0] for c in mock_run.call_args_list] == [
        "docker", "docker", "gcloud"]
    with patch.object(deploy, "run", return_value=MagicMock(returncode=1)):
        with pytest.raises(SystemExit):
            deploy.build_container("img")
    with patch.object(deploy, "run", return_value=MagicMock(
            returncode=1, stderr="denied")):
        with pytest.raises(SystemExit):
            deploy.deploy_job("mnist-training", project="p", region="r",
                              no_build=True, image_uri="img")


def test_main_parses_the_job_type():
    with patch.object(deploy, "deploy_job") as mock_deploy:
        deploy.main(["mnist-sampling", "--no-build", "--project", "p"])
    args, kw = mock_deploy.call_args
    assert args == ("mnist-sampling",)
    assert kw["no_build"] and kw["project"] == "p"
    with pytest.raises(SystemExit):
        deploy.main(["not-a-job"])
