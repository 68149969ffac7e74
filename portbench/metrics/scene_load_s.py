"""Host seconds of the program's ``scene.load`` set-up span in this
process: ``scene.load_scene`` (the scene file, its shapes, the grid, the
BVH build on the host and the tables on the card), a part of
``setup_s``."""


def read(ctx):
    try:
        from corona13_tpu_torch.tracing import setup_seconds
    except ImportError:          # a program without set-up spans
        return None
    return setup_seconds().get('scene.load')
