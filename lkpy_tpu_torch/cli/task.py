"""``lkpy-tpu-torch task`` wrapper (port of ``lkpy_tpu/cli/task.py``;
reference: src/lenskit/cli/task.py:28): run a subcommand inside a tracked
Task, saving the task record to a file."""

from __future__ import annotations

import click


@click.command("task", context_settings={"ignore_unknown_options": True})
@click.option("--save-to", type=click.Path(), required=True, help="task record JSON output")
@click.option("--label", default="cli-task")
@click.argument("args", nargs=-1, type=click.UNPROCESSED)
@click.pass_context
def task(ctx, save_to, label, args):
    """Run another lkpy-tpu-torch command inside a tracked task."""
    from lkpy_tpu_torch.cli import cli
    from lkpy_tpu_torch.logging import Task

    # the subcommand runs on the outer command's device unless it names its own
    device = ctx.find_object(dict).get("device")
    inner = (["--device", device] if device else []) + list(args)
    with Task(label, file=save_to):
        cli.main(args=inner, standalone_mode=False, auto_envvar_prefix="LKT")
    click.echo(f"task record saved to {save_to}")
