"""``lkpy-tpu-torch profile`` subcommands (port of ``lkpy_tpu/cli/profile_cmd.py``;
reference: src/lenskit/cli/profile/summarize.py)."""

from __future__ import annotations

import click


@click.group("profile")
def profile():
    """Pipeline profiling utilities."""


@profile.command("summarize")
@click.argument("file", type=click.Path(exists=True))
def summarize(file):
    """Summarize a pipeline profile CSV."""
    from lkpy_tpu_torch.pipeline import summarize_profile

    df = summarize_profile(file)
    click.echo(df.to_string(float_format=lambda v: f"{v:.3f}"))
