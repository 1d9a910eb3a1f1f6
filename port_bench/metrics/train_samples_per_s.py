"""train_samples_per_s: the samples of every step completed in the window
over the window's whole length (it ends when the last step's scalars are
on the host, after a synchronize)."""


def read(record):
    if record.get("family") != "train" or record["window_s"] <= 0:
        return None
    return record["steps"] * record["batch_size"] / record["window_s"]
