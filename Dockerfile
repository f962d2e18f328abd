# Container image for the QKD LDPC framework on NVIDIA GPUs.
#
# Mirrors the reference's deployment contract (Dockerfile + docker-compose
# with configs/matrices/results volumes): a slim Python base with the CUDA
# build of JAX (jax[cuda12], which brings its own CUDA libraries) and the
# package installed, the native host-side helper library pre-built, and the
# CLI as the entrypoint. Run it with the NVIDIA container runtime
# (`docker run --gpus all ...`); without a GPU the same image runs on the
# CPU backend (JAX_PLATFORMS=cpu).

FROM python:3.12-slim AS builder

RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app

COPY pyproject.toml README.md /app/
COPY qkd_ldpc_v_tpu/ /app/qkd_ldpc_v_tpu/
COPY native/ /app/native/

# Native helper library (optional at runtime; Python fallbacks are
# bit-identical). Built here so the runtime image needs no toolchain.
RUN make -C native \
    && pip wheel --no-deps -w /app/dist .


FROM python:3.12-slim AS runtime

WORKDIR /app

COPY --from=builder /app/dist/*.whl /tmp/
COPY --from=builder /app/native/libqkdldpc_native.so /app/native/

RUN pip install --no-cache-dir /tmp/*.whl "jax[cuda12]" \
    && rm /tmp/*.whl

ENV QKDLDPC_NATIVE_LIB=/app/native/libqkdldpc_native.so

# Same volume layout as the reference container: drop configs in /app/configs,
# matrices (per-format subdirectories) in /app/sparse_matrices, and collect
# CSVs from /app/results.
ENTRYPOINT ["qkd-ldpc-tpu", "--configs", "/app/configs", \
            "--matrices", "/app/sparse_matrices", "--results", "/app/results"]
