#!/bin/sh
# Build the port's images, tagged with the names the port's manifests
# render (kubeflow_tpu_torch/manifests/images.py: TORCH_CUDA, and NOTEBOOK
# for the notebook stage). The recipe lives outside docker/ because
# docker/*/Dockerfile is the JAX platform's set.
#
# Usage: docker_torch/build_image.sh
set -e

cd "$(dirname "$0")/.."
# images.py imports nothing, so the host needs no torch to read the tag.
TAG="$(python3 -c 'exec(open("kubeflow_tpu_torch/manifests/images.py").read()); print(TORCH_CUDA)')"

NOTEBOOK_TAG="$(python3 -c 'exec(open("kubeflow_tpu_torch/manifests/images.py").read()); print(NOTEBOOK)')"

docker build -f docker_torch/Dockerfile --target runtime -t "${TAG}" .
docker build -f docker_torch/Dockerfile --target notebook -t "${NOTEBOOK_TAG}" .
echo "built: ${TAG} ${NOTEBOOK_TAG}"
