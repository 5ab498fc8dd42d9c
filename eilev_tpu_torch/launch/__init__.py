"""Job scripts for the port's CLIs (counterpart of ``launch/``): each
``python -m eilev_tpu_torch.launch.submit_<job> ...`` writes ``<job>.sh`` and
runs it here (``--backend local``) or submits it with ``sbatch``
(``--backend slurm``); ``--dry_run`` writes and prints it only. A
multi-process job runs ``torchrun --nproc_per_node N -m
eilev_tpu_torch.cli.<name>``."""
