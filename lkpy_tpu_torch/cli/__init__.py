"""
Command-line interface (port of ``lkpy_tpu/cli``).

Capability parity with the reference CLI (reference: src/lenskit/cli/__init__.py:47
click group with subcommands ``data``, ``train``, ``recommend``, ``tune``,
``pipeline``, ``doctor``, ``task``).

The group's ``--device`` (``LKT_DEVICE``) takes the place of the JAX
package's ``JAX_PLATFORMS``: ``train`` and ``tune`` run on the card unless
it says ``cpu``, and without a card they raise.  ``recommend`` serves where
the trained pipeline's tables lie.
"""

from __future__ import annotations

import click

from lkpy_tpu_torch.logging import LoggingConfig

__all__ = ["main", "cli"]


@click.group("lkpy-tpu-torch")
@click.option("-v", "--verbose", count=True, help="enable verbose logging")
@click.option("--device", default=None, help="torch device to train on: the card (cuda) unless 'cpu'")
@click.pass_context
def cli(ctx: click.Context, verbose: int, device: str | None):
    """lkpy-tpu-torch: the PyTorch/CUDA recommender toolkit."""
    lc = LoggingConfig()
    if verbose:
        lc.set_verbose(verbose)
    lc.apply()
    ctx.ensure_object(dict)["device"] = device


from lkpy_tpu_torch.cli.config_cmd import config  # noqa: E402
from lkpy_tpu_torch.cli.data import data  # noqa: E402
from lkpy_tpu_torch.cli.doctor import doctor  # noqa: E402
from lkpy_tpu_torch.cli.pipeline_cmd import pipeline  # noqa: E402
from lkpy_tpu_torch.cli.profile_cmd import profile  # noqa: E402
from lkpy_tpu_torch.cli.recommend import recommend  # noqa: E402
from lkpy_tpu_torch.cli.task import task  # noqa: E402
from lkpy_tpu_torch.cli.train import train  # noqa: E402
from lkpy_tpu_torch.cli.tune import tune  # noqa: E402

cli.add_command(config)
cli.add_command(data)
cli.add_command(doctor)
cli.add_command(pipeline)
cli.add_command(profile)
cli.add_command(recommend)
cli.add_command(task)
cli.add_command(train)
cli.add_command(tune)


def main():
    cli(auto_envvar_prefix="LKT")


if __name__ == "__main__":
    main()
