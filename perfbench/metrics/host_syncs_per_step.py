"""Device-to-host syncs of one step after the profiled ones, counted
under ``torch.cuda.set_sync_debug_mode('warn')`` (the program's
``_prepare_inputs`` copies, its data-dependent sizes, the loss read)."""


def read(ctx):
  return None if ctx.host_syncs is None else float(ctx.host_syncs)
