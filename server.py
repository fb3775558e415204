#!/usr/bin/env python
"""MCP stdio server entry point — the drop-in equivalent of the reference's
``python fenics_mcp_server.py`` (fenics_mcp_server.py:4554-4555), exposing
the same 13 tools backed by the JAX solvers."""

from pde_solver.mcp.server import main

if __name__ == "__main__":
    main()
