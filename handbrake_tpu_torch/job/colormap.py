"""Color names → RGB/YUV for pad backgrounds (colormap.c analog)."""
from __future__ import annotations

COLORS = {
    "black": 0x000000, "white": 0xFFFFFF, "gray": 0x808080,
    "grey": 0x808080, "silver": 0xC0C0C0, "red": 0xFF0000,
    "darkred": 0x8B0000, "maroon": 0x800000, "green": 0x008000,
    "lime": 0x00FF00, "darkgreen": 0x006400, "blue": 0x0000FF,
    "navy": 0x000080, "darkblue": 0x00008B, "cyan": 0x00FFFF,
    "aqua": 0x00FFFF, "teal": 0x008080, "magenta": 0xFF00FF,
    "fuchsia": 0xFF00FF, "purple": 0x800080, "violet": 0xEE82EE,
    "yellow": 0xFFFF00, "gold": 0xFFD700, "olive": 0x808000,
    "orange": 0xFFA500, "darkorange": 0xFF8C00, "brown": 0xA52A2A,
    "pink": 0xFFC0CB, "beige": 0xF5F5DC, "ivory": 0xFFFFF0,
    "khaki": 0xF0E68C, "lavender": 0xE6E6FA, "salmon": 0xFA8072,
    "turquoise": 0x40E0D0, "indigo": 0x4B0082, "coral": 0xFF7F50,
    "crimson": 0xDC143C, "slategray": 0x708090, "slategrey": 0x708090,
    "darkslategray": 0x2F4F4F, "lightgray": 0xD3D3D3,
    "lightgrey": 0xD3D3D3, "dimgray": 0x696969, "dimgrey": 0x696969,
    "snow": 0xFFFAFA, "mintcream": 0xF5FFFA, "azure": 0xF0FFFF,
    "aliceblue": 0xF0F8FF, "skyblue": 0x87CEEB, "steelblue": 0x4682B4,
    "royalblue": 0x4169E1, "midnightblue": 0x191970,
    "forestgreen": 0x228B22, "seagreen": 0x2E8B57,
    "springgreen": 0x00FF7F, "chartreuse": 0x7FFF00,
    "greenyellow": 0xADFF2F, "tomato": 0xFF6347, "orangered": 0xFF4500,
    "hotpink": 0xFF69B4, "deeppink": 0xFF1493, "plum": 0xDDA0DD,
    "orchid": 0xDA70D6, "tan": 0xD2B48C, "chocolate": 0xD2691E,
    "sienna": 0xA0522D, "peru": 0xCD853F, "wheat": 0xF5DEB3,
}


def name_to_rgb(name: str) -> int:
    name = name.strip().lower()
    if name.startswith("#"):
        return int(name[1:], 16)
    if name.startswith("0x"):
        return int(name, 16)
    if name in COLORS:
        return COLORS[name]
    raise ValueError(f"unknown color {name!r}")


def rgb_to_yuv(rgb: int, bit_depth: int = 8, matrix: str = "bt709") -> tuple:
    """Full→limited range BT.601/709 conversion for fill colors."""
    r = (rgb >> 16) & 0xFF
    g = (rgb >> 8) & 0xFF
    b = rgb & 0xFF
    if matrix == "bt601":
        kr, kb = 0.299, 0.114
    else:
        kr, kb = 0.2126, 0.0722
    kg = 1.0 - kr - kb
    y = kr * r + kg * g + kb * b
    u = (b - y) / (2 * (1 - kb))
    v = (r - y) / (2 * (1 - kr))
    # limited range mapping
    y = 16 + y * 219 / 255
    u = 128 + u * 224 / 255
    v = 128 + v * 224 / 255
    shift = bit_depth - 8
    return (int(round(y)) << shift, int(round(u)) << shift,
            int(round(v)) << shift)
