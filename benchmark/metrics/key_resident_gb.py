"""Key bytes resident at the window's end, in 10^9 bytes: the rotation
key store's and the relinearisation key's."""


def read(run):
    return (run.after["store"]["resident_bytes"]
            + run.after["ctx"]["relin_key_bytes"]) / 1e9
