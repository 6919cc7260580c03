"""TPU pod provisioning descriptor (reference `aws/ec2/provision/
ClusterSetup.java` role, SURVEY §2.4).

The reference shells out to the AWS SDK to stand up EC2 workers. The TPU
equivalent is a TPU-VM/pod slice; actually creating one is an infra action
this environment cannot perform (no egress), so the descriptor renders the
exact `gcloud` commands — scriptable, reviewable, testable. (Counterpart
of `deeplearning4j_tpu/cloud/provision.py`, copied with its names: the
port renders and runs the same commands it is given, nothing more.)"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class TpuPodSpec:
    """Describes a TPU pod slice for a training job."""

    name: str
    accelerator_type: str = "v5litepod-8"  # e.g. v5litepod-8, v4-32
    zone: str = "us-central1-a"
    runtime_version: str = "tpu-ubuntu2204-base"
    project: str = ""
    preemptible: bool = False
    labels: Dict[str, str] = field(default_factory=dict)

    def create_command(self) -> List[str]:
        cmd = ["gcloud", "compute", "tpus", "tpu-vm", "create", self.name,
               f"--zone={self.zone}",
               f"--accelerator-type={self.accelerator_type}",
               f"--version={self.runtime_version}"]
        if self.project:
            cmd.append(f"--project={self.project}")
        if self.preemptible:
            cmd.append("--preemptible")
        if self.labels:
            cmd.append("--labels=" + ",".join(
                f"{k}={v}" for k, v in sorted(self.labels.items())))
        return cmd

    def delete_command(self) -> List[str]:
        cmd = ["gcloud", "compute", "tpus", "tpu-vm", "delete", self.name,
               f"--zone={self.zone}", "--quiet"]
        if self.project:
            cmd.append(f"--project={self.project}")
        return cmd

    def ssh_command(self, worker: str = "all", command: str = "") -> List[str]:
        cmd = ["gcloud", "compute", "tpus", "tpu-vm", "ssh", self.name,
               f"--zone={self.zone}", f"--worker={worker}"]
        if command:
            cmd.append(f"--command={command}")
        return cmd

    @property
    def num_chips(self) -> int:
        """Chip count from the accelerator type. The numeric suffix counts
        CHIPS for v5e/v5p/v6e-style names (v5litepod-8 → 8) but TENSORCORES
        for v2/v3/v4 (v4-32 → 16 chips: 2 cores per chip)."""
        gen, _, suffix = self.accelerator_type.rpartition("-")
        try:
            n = int(suffix)
        except ValueError:
            raise ValueError(
                f"cannot parse chip count from accelerator type "
                f"{self.accelerator_type!r}")
        if gen in ("v2", "v3", "v4"):
            return n // 2
        return n


class ClusterSetup:
    """Executes the rendered provisioning commands (the reference's
    `ClusterSetup.java` actually stands up the cluster; rendering-only was
    this module's r2 state). `execute=False` stays the review path: the
    command is returned, nothing runs. `execute=True` runs it via
    subprocess and raises with the tool's stderr on failure.

    `gcloud_binary`: override the executable — CI proves the execute path
    against a fake gcloud double without egress
    (`tests/test_torch_cloud.py`), the same seam a bastion/wrapper
    script would use in production."""

    def __init__(self, spec: TpuPodSpec, gcloud_binary: str = "gcloud"):
        self.spec = spec
        self.gcloud_binary = gcloud_binary

    def _run(self, cmd: List[str], execute: bool):
        # substitute the binary in BOTH paths: the rendered command must
        # be exactly what --execute would run (an operator copy-pasting a
        # render that said plain `gcloud` while execute used a wrapper
        # would invoke the wrong tool)
        cmd = [self.gcloud_binary] + cmd[1:]
        if not execute:
            return cmd
        import subprocess

        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"provisioning command failed ({res.returncode}): "
                f"{' '.join(cmd)}\n{res.stderr.strip()}")
        return res

    def create(self, execute: bool = False):
        return self._run(self.spec.create_command(), execute)

    def delete(self, execute: bool = False):
        return self._run(self.spec.delete_command(), execute)

    def ssh(self, command: str = "", worker: str = "all",
            execute: bool = False):
        return self._run(self.spec.ssh_command(worker, command), execute)


def _main() -> None:
    """CLI: render (default) or --execute the provisioning commands.

        python -m deeplearning4j_tpu_torch.cloud.provision create \
            --name pod0 --accelerator-type v5litepod-8 [--execute]
    """
    import argparse
    import shlex
    import sys

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("action", choices=["create", "delete", "ssh"])
    ap.add_argument("--name", required=True)
    ap.add_argument("--accelerator-type", default="v5litepod-8")
    ap.add_argument("--zone", default="us-central1-a")
    ap.add_argument("--runtime-version", default="tpu-ubuntu2204-base")
    ap.add_argument("--project", default="")
    ap.add_argument("--preemptible", action="store_true")
    ap.add_argument("--command", default="", help="ssh remote command")
    ap.add_argument("--worker", default="all")
    ap.add_argument("--execute", action="store_true",
                    help="actually run the command (default: render only)")
    ap.add_argument("--gcloud", default="gcloud",
                    help="gcloud executable (test doubles / wrappers)")
    args = ap.parse_args()
    spec = TpuPodSpec(name=args.name, accelerator_type=args.accelerator_type,
                      zone=args.zone, runtime_version=args.runtime_version,
                      project=args.project, preemptible=args.preemptible)
    setup = ClusterSetup(spec, gcloud_binary=args.gcloud)
    fn = {"create": setup.create, "delete": setup.delete,
          "ssh": lambda execute: setup.ssh(args.command, args.worker,
                                           execute)}[args.action]
    out = fn(execute=args.execute)
    if args.execute:
        sys.stdout.write(out.stdout)
        print(f"EXECUTED rc={out.returncode}")
    else:
        print(shlex.join(out))


if __name__ == "__main__":
    _main()
