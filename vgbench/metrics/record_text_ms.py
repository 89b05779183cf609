"""record_text_ms: ctx.profiler's `record.text` stage (Context.text and
textBox: glyph layout, atlas bake and the textured quads), ms per frame."""

LAYER = "recorder: api.context begin and draw calls, scenes"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate"]


def read(obs):
    return obs.stage_ms("record.text")
