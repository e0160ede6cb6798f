"""Pipeline runtime (L4): elements, pads, negotiation, bus, parser."""

from .element import (
    Element,
    NegotiationError,
    Pad,
    PadDirection,
    SinkElement,
    SourceElement,
    StreamError,
    TransformElement,
)
from .events import Event, EventKind, Message, MessageKind
from .parser import ParseError, parse_caps_string, parse_launch
from .pipeline import Bus, Pipeline
from .registry import element_factory, list_elements, make, register_element

__all__ = [
    "Element", "NegotiationError", "Pad", "PadDirection", "SinkElement",
    "SourceElement", "StreamError", "TransformElement",
    "Event", "EventKind", "Message", "MessageKind",
    "ParseError", "parse_caps_string", "parse_launch",
    "Bus", "Pipeline",
    "element_factory", "list_elements", "make", "register_element",
]
