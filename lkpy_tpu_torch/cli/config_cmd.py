"""``lkpy-tpu-torch config`` — show active configuration (port of
``lkpy_tpu/cli/config_cmd.py``; reference: cli/config.py)."""

from __future__ import annotations

import json

import click


@click.command("config")
@click.option("--json", "as_json", is_flag=True, help="emit JSON")
def config(as_json: bool):
    """Print the active configuration."""
    from lkpy_tpu_torch.config import lkpy_tpu_config

    cfg = lkpy_tpu_config()
    if as_json:
        click.echo(cfg.model_dump_json(indent=2))
    else:
        for line in json.dumps(cfg.model_dump(), indent=2).splitlines():
            click.echo(line)
