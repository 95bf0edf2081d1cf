"""The programs a cell's traffic can name: ``<name>.py`` defines
``call(stack, settings, device, k)``, which returns the port's
``AlignResult``, and may define ``prepare(stack, settings, device, k,
workdir)``, which the harness runs before each call, outside its wall."""
