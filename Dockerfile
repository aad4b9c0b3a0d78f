# Container recipe for the color-depth-search toolset.
#
# Counterpart of the reference's two-stage Dockerfile (Dockerfile:1-28:
# jdk builder stage producing the jar-with-dependencies, runtime stage
# carrying only the artifact). Here the builder stage wheels the
# package; the runtime stage installs the wheel and exposes the same
# CLI surface.
#
# Build:  docker build -t colormipsearch-tpu .
# Run:    docker run --gpus all colormipsearch-tpu colorDepthSearch --help
# The active-tile kernel needs JAX's CUDA plugin (pip install
# "jax[cuda12]") and a visible NVIDIA GPU; without one the CLI runs the
# dense engine on the CPU.

FROM python:3.11-slim AS builder
WORKDIR /src
COPY pyproject.toml README.md ./
COPY colormipsearch_tpu ./colormipsearch_tpu
RUN pip install --no-cache-dir build \
 && python -m build --wheel --outdir /dist

FROM python:3.11-slim
# g++/OpenMP for the lazily-built native mipops helper (optional:
# NumPy fallbacks cover hosts without it)
RUN apt-get update -y \
 && apt-get install -y --no-install-recommends g++ libgomp1 \
 && rm -rf /var/lib/apt/lists/*
WORKDIR /app
COPY --from=builder /dist/*.whl /tmp/
RUN pip install --no-cache-dir /tmp/*.whl "jax[cuda12]" && rm /tmp/*.whl
ENTRYPOINT ["colormipsearch-tpu"]
CMD ["--help"]
