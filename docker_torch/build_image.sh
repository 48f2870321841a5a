#!/bin/sh
# Build the port's image, tagged with the name the port's manifests render
# (kubeflow_tpu_torch/manifests/images.py: TORCH_CUDA). The recipe lives
# outside docker/ because docker/*/Dockerfile is the JAX platform's set.
#
# Usage: docker_torch/build_image.sh
set -e

cd "$(dirname "$0")/.."
# images.py imports nothing, so the host needs no torch to read the tag.
TAG="$(python3 -c 'exec(open("kubeflow_tpu_torch/manifests/images.py").read()); print(TORCH_CUDA)')"

docker build -f docker_torch/Dockerfile --target runtime -t "${TAG}" .
echo "built: ${TAG}"
