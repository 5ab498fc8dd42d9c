"""The EPIC-KITCHENS data tools (counterparts of ``scripts/epic_kitchens/``),
each run as ``python -m eilev_tpu_torch.cli.epic_kitchens.<name>``:
``epic_kitchens_extract_frames`` (clips -> resized frames +
``narrated_actions.csv``) and ``transform_to_full_sent`` (phrases -> full
sentences through ``TextLM``)."""
