"""unet.spec_rows_per_window: rows through SpecUnet's spectrogram stream
(`diffroll_tpu_torch.nn.unet.spec_rows`, the program's counter) over the
windows transcribed, over the whole window: 2 where the stream runs once a
batch on both guidance branches, 2 T where every step runs the whole forward.
Nothing where the program does not count them."""


def read(run):
    r = run.records
    if r.get("unet.spec_rows") is None or not r.get("windows"):
        return None
    return r["unet.spec_rows"] / r["windows"]
