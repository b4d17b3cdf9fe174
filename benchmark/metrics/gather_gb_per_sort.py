"""Bytes each mesh slot received from the others per sort in the window,
summed over the gathers' tags (mesh.gathers), in 10^9 bytes.  Nothing to
read without a mesh."""


def read(run):
    before, after = run.before["mesh"], run.after["mesh"]
    if "gathers" not in after or not run.sorts:
        return None
    old = before["gathers"]
    d = sum(g["bytes_per_slot"] - old.get(t, {}).get("bytes_per_slot", 0)
            for t, g in after["gathers"].items())
    return d / run.sorts / 1e9
