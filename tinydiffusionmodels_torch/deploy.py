"""Build, push and submit the port's H100 jobs (counterpart of
``deployment/deploy.py``, which serves the JAX package on TPU v5e).

    python -m tinydiffusionmodels_torch.deploy JOB_TYPE [--no-build]
        [--project P] [--region R] [--image URI]

The image is ``deployment/h100/Dockerfile`` (a CUDA devel base with
PyTorch: the kernels are built with nvcc for sm_90a), built from the repo
root and pushed; the job is a Vertex AI custom job from
``deployment/h100/configs/JOB_TYPE.yaml``, every one on NVIDIA H100 80GB
cards (``a3-highgpu-*``): one card, or for the sequence-parallel jobs
``torchrun`` over the 8 of one host. Project, region and image come from
flags or the environment (``TDM_GCP_PROJECT``, ``TDM_GCP_REGION``,
``TDM_H100_IMAGE_URI``). ``deployment/monitor.py`` follows a submitted job.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
DEPLOY_DIR = REPO_ROOT / "deployment" / "h100"
CONFIG_DIR = DEPLOY_DIR / "configs"
DOCKERFILE = DEPLOY_DIR / "Dockerfile"

DEFAULT_PROJECT = os.environ.get("TDM_GCP_PROJECT", "learnagentspace")
DEFAULT_REGION = os.environ.get("TDM_GCP_REGION", "us-central1")
DEFAULT_IMAGE = os.environ.get(
    "TDM_H100_IMAGE_URI",
    f"gcr.io/{DEFAULT_PROJECT}/text-diffusion-h100:latest")

# The JAX package's job types (deployment/deploy.py), and the data x
# sequence job whose config it keeps beside them.
JOB_TYPES = (
    "shakespeare-training",
    "shakespeare-sampling",
    "mnist-training",
    "mnist-sampling",
    "shakespeare-training-sp",
    "shakespeare-training-quality",
    "shakespeare-training-dp4sp2",
)


def run(cmd: list[str], **kwargs):
    print(f"$ {' '.join(cmd)}")
    return subprocess.run(cmd, **kwargs)


def build_container(image_uri: str) -> None:
    """docker build (``deployment/h100/Dockerfile``, the repo root as the
    context) and push; exits on a failure."""
    result = run(["docker", "build", "-f", str(DOCKERFILE), "-t", image_uri,
                  str(REPO_ROOT)])
    if result.returncode != 0:
        print("Container build failed")
        sys.exit(1)
    result = run(["docker", "push", image_uri])
    if result.returncode != 0:
        print("Container push failed")
        sys.exit(1)
    print(f"Built and pushed {image_uri}")


def deploy_job(job_type: str, *, project: str, region: str,
               no_build: bool, image_uri: str) -> str | None:
    """Submit a Vertex AI custom job from ``configs/{job_type}.yaml``
    (building the image first unless ``no_build``); the job's id, or None
    when the reply names none. Exits on a failure."""
    if not no_build:
        build_container(image_uri)
    config_path = CONFIG_DIR / f"{job_type}.yaml"
    if not config_path.exists():
        print(f"Config not found: {config_path}")
        sys.exit(1)
    result = run(
        ["gcloud", "ai", "custom-jobs", "create", f"--region={region}",
         f"--project={project}", f"--display-name={job_type}",
         f"--config={config_path}", "--format=json"],
        capture_output=True, text=True)
    if result.returncode != 0:
        print(f"Job submission failed:\n{result.stderr}")
        sys.exit(1)
    try:
        job_id = json.loads(result.stdout).get("name", "").split("/")[-1]
    except (json.JSONDecodeError, AttributeError):
        job_id = None
    print(f"Submitted {job_type}")
    if job_id:
        print(f"  Job ID: {job_id}")
        print(f"  Monitor: python deployment/monitor.py {job_id}")
        print(f"  Logs:    python deployment/monitor.py {job_id} --logs")
    return job_id or None


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("job_type", choices=JOB_TYPES)
    parser.add_argument("--no-build", action="store_true",
                        help="skip docker build and push")
    parser.add_argument("--project", default=DEFAULT_PROJECT)
    parser.add_argument("--region", default=DEFAULT_REGION)
    parser.add_argument("--image", default=DEFAULT_IMAGE)
    args = parser.parse_args(argv)
    deploy_job(args.job_type, project=args.project, region=args.region,
               no_build=args.no_build, image_uri=args.image)


if __name__ == "__main__":
    main()
