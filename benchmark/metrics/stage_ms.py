"""The host's copy of the images into the batch encode program's pinned
buffer, ms an image: the program's own ``stage_s`` read after each call
of the window, summed, over the images of those calls."""


def read(records, direction):
    calls = [c for c in records.calls
             if c["direction"] == direction and "stage_s" in c]
    images = sum(c["images"] for c in calls)
    if not images:
        return None
    return 1e3 * sum(c["stage_s"] for c in calls) / images
