# PDE solver — container image.
# Replaces the reference's conda/FEniCS stack (reference Dockerfile:18-24)
# with a plain pip install: the solve core is pure JAX + a small C++ host
# library built at image build time.

FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make && \
    rm -rf /var/lib/apt/lists/*

WORKDIR /app

# CPU JAX by default; for NVIDIA GPUs install the CUDA build instead:
#   pip install "jax[cuda12]"
# The solve path imports only jax, numpy and scipy; streamlit and requests
# serve the web UI and the optional LLM.
RUN pip install --no-cache-dir jax numpy scipy requests streamlit

COPY pyproject.toml ./
COPY pde_solver ./pde_solver
COPY native ./native
COPY server.py app.py ./

RUN pip install --no-cache-dir -e . && \
    python -c "from pde_solver import native; assert native.available()" && \
    python -c "from pde_solver import api; print('solvers importable')"

EXPOSE 8501

HEALTHCHECK --interval=30s --timeout=10s --start-period=40s --retries=3 \
    CMD python -c "import urllib.request; urllib.request.urlopen('http://localhost:8501/_stcore/health')" || exit 1

CMD ["streamlit", "run", "app.py", "--server.port=8501", "--server.address=0.0.0.0"]
