"""MCP protocol tests: in-process handler + real stdio subprocess round-trip."""

import asyncio
import json
import os
import sys

import pytest

from pde_solver.mcp.server import MCPServer, tool_descriptor, default_tools


def test_initialize_and_tools_list():
    srv = MCPServer()
    resp = srv.handle({"jsonrpc": "2.0", "id": 1, "method": "initialize",
                       "params": {"protocolVersion": "2024-11-05"}})
    assert resp["result"]["serverInfo"]["name"] == "pde-solver"
    assert srv.handle({"jsonrpc": "2.0", "method": "notifications/initialized"}) is None
    resp = srv.handle({"jsonrpc": "2.0", "id": 2, "method": "tools/list"})
    tools = resp["result"]["tools"]
    names = {t["name"] for t in tools}
    # the reference's 13-tool surface (fenics_mcp_server.py table in
    # SURVEY §2) plus the elastodynamics + wave extension tools
    assert names == {
        "solve_heat_1D", "solve_heat_2D", "solve_heat_3D",
        "solve_heat_3D_spherical", "solve_heat_1D_cylindrical",
        "solve_heat_1D_spherical", "solve_heat_2D_cylindrical",
        "solve_heat_2D_spherical", "solve_elasticity_1D_static",
        "solve_elasticity_2D_static", "solve_elasticity_3D_static",
        "plot_time_series_field_from_file", "plot_time_series_field",
        "solve_elasticity_3D_dynamic",
        "solve_wave_1D", "solve_wave_2D", "solve_wave_3D",
        "solve_heat_1D_mixed", "solve_heat_2D_mixed", "solve_heat_3D_mixed",
        "solve_heat_radial_mixed",
        "solve_elasticity_1D_loaded", "solve_elasticity_2D_loaded",
        "solve_elasticity_3D_loaded",
        "solve_advection_1D", "solve_advection_2D", "solve_advection_3D",
        "solve_elasticity_2D_modal", "solve_elasticity_3D_modal",
        "solve_heat_1D_nonlinear", "solve_heat_2D_nonlinear",
    }


def test_tool_descriptor_schema():
    fn = default_tools()["solve_heat_1D"]
    desc = tool_descriptor(fn)
    props = desc["inputSchema"]["properties"]
    assert props["length"] == {"type": "number", "default": 2.0}
    assert props["nx"] == {"type": "integer", "default": 50}
    assert desc["inputSchema"]["required"] == []


def test_tools_call_round_trip(tmp_path):
    srv = MCPServer()
    resp = srv.handle({"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                       "params": {"name": "solve_heat_1D",
                                  "arguments": {"nx": 8, "num_steps": 2,
                                                "data_dir": str(tmp_path)}}})
    result = resp["result"]
    assert result["isError"] is False
    payload = json.loads(result["content"][0]["text"])
    assert os.path.exists(payload["data_file"])
    assert payload["dim"] == 1


def test_tools_call_unknown_tool_is_error_content():
    srv = MCPServer()
    resp = srv.handle({"jsonrpc": "2.0", "id": 4, "method": "tools/call",
                       "params": {"name": "nope", "arguments": {}}})
    assert resp["result"]["isError"] is True


def test_unknown_method_error():
    srv = MCPServer()
    resp = srv.handle({"jsonrpc": "2.0", "id": 5, "method": "bogus/method"})
    assert resp["error"]["code"] == -32601


@pytest.mark.slow
def test_stdio_subprocess_round_trip(tmp_path):
    """Spawn the real server.py subprocess and run solve+plot through MCP."""
    from pde_solver.mcp.client import StdioMCPClient

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env_script = os.path.join(repo, "server.py")

    async def scenario():
        client = StdioMCPClient([sys.executable, env_script])
        try:
            tools = await client.list_tools()
            assert len(tools) == 31
            res = await client.call_tool("solve_heat_1D", {
                "nx": 8, "num_steps": 2, "data_dir": str(tmp_path)})
            assert os.path.exists(res["data_file"])
            plot = await client.call_tool("plot_time_series_field_from_file", {
                "data_file": res["data_file"],
                "output_dir": str(tmp_path / "plots")})
            assert os.path.exists(plot["html_path"])
            # error path: bad tool name
            bad = await client.call_tool("does_not_exist", {})
            assert "error" in bad
        finally:
            await client.close()

    asyncio.new_event_loop().run_until_complete(scenario())
