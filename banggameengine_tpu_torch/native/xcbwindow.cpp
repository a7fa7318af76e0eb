// Native presentation window over libxcb, loaded at runtime with dlopen.
//
// The TPU engine renders into a device framebuffer that the host fetches as
// an RGBA numpy array; this file is the "actually display it" path the
// reference gets from GLFW + bgfx's swap chain (Window.cpp:6-28,
// Renderer.cpp:733-736 bgfx::frame()).  Python binds via ctypes
// (xcbwindow_binding.py); when no X server is reachable bang_win_open
// returns NULL and the engine stays headless (the reference's Noop-backend
// degradation, Renderer.cpp:156).
//
// No X11/xcb headers are required at build time: the handful of structs and
// calls used below are declared from the public, stable libxcb ABI
// (X protocol spec); symbols resolve from libxcb.so.1 at runtime.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>

// ---------------------------------------------------------------------------
// minimal xcb ABI declarations (public protocol layout)
// ---------------------------------------------------------------------------
extern "C" {

typedef struct xcb_connection_t xcb_connection_t;

typedef struct {
    uint8_t status, pad0;
    uint16_t protocol_major_version, protocol_minor_version;
    uint16_t length;
    uint32_t release_number;
    uint32_t resource_id_base, resource_id_mask;
    uint32_t motion_buffer_size;
    uint16_t vendor_len;
    uint16_t maximum_request_length;
    uint8_t roots_len, pixmap_formats_len;
    uint8_t image_byte_order, bitmap_format_bit_order;
    uint8_t bitmap_format_scanline_unit, bitmap_format_scanline_pad;
    uint8_t min_keycode, max_keycode;
    uint8_t pad1[4];
} xcb_setup_t;

typedef struct {
    uint32_t root;
    uint32_t default_colormap;
    uint32_t white_pixel, black_pixel;
    uint32_t current_input_masks;
    uint16_t width_in_pixels, height_in_pixels;
    uint16_t width_in_millimeters, height_in_millimeters;
    uint16_t min_installed_maps, max_installed_maps;
    uint32_t root_visual;
    uint8_t backing_stores, save_unders, root_depth, allowed_depths_len;
} xcb_screen_t;

typedef struct {
    xcb_screen_t *data;
    int rem, index;
} xcb_screen_iterator_t;

typedef struct {
    uint8_t response_type, pad0;
    uint16_t sequence;
    uint32_t pad[7];
    uint32_t full_sequence;
} xcb_generic_event_t;

// key/button/motion events share this layout (X protocol)
typedef struct {
    uint8_t response_type;
    uint8_t detail;           // keycode / button
    uint16_t sequence;
    uint32_t time;
    uint32_t root, event, child;
    int16_t root_x, root_y;
    int16_t event_x, event_y;
    uint16_t state;
    uint8_t same_screen, pad0;
} xcb_input_event_t;

typedef struct {
    uint8_t response_type, format;
    uint16_t sequence;
    uint32_t length;
    uint32_t atom;
} xcb_intern_atom_reply_t;

typedef struct {
    uint8_t response_type, pad0;
    uint16_t sequence;
    uint32_t pad[7];
} xcb_client_message_prefix_t;  // data words follow at offset 12

typedef struct { unsigned int sequence; } xcb_void_cookie_t;
typedef struct { unsigned int sequence; } xcb_intern_atom_cookie_t;
typedef struct { unsigned int sequence; } xcb_kbmap_cookie_t;

typedef struct {
    uint8_t response_type, keysyms_per_keycode;
    uint16_t sequence;
    uint32_t length;
    uint8_t pad[24];
} xcb_get_keyboard_mapping_reply_t;

}  // extern "C"

namespace {

// resolved libxcb entry points
struct XcbApi {
    void *lib = nullptr;
    xcb_connection_t *(*connect)(const char *, int *);
    int (*connection_has_error)(xcb_connection_t *);
    void (*disconnect)(xcb_connection_t *);
    const xcb_setup_t *(*get_setup)(xcb_connection_t *);
    xcb_screen_iterator_t (*setup_roots_iterator)(const xcb_setup_t *);
    uint32_t (*generate_id)(xcb_connection_t *);
    xcb_void_cookie_t (*create_window)(
        xcb_connection_t *, uint8_t depth, uint32_t wid, uint32_t parent,
        int16_t x, int16_t y, uint16_t w, uint16_t h, uint16_t border,
        uint16_t win_class, uint32_t visual, uint32_t value_mask,
        const void *value_list);
    xcb_void_cookie_t (*map_window)(xcb_connection_t *, uint32_t);
    xcb_void_cookie_t (*create_gc)(xcb_connection_t *, uint32_t cid,
                                   uint32_t drawable, uint32_t value_mask,
                                   const void *value_list);
    xcb_void_cookie_t (*put_image)(
        xcb_connection_t *, uint8_t format, uint32_t drawable, uint32_t gc,
        uint16_t w, uint16_t h, int16_t x, int16_t y, uint8_t left_pad,
        uint8_t depth, uint32_t data_len, const uint8_t *data);
    int (*flush)(xcb_connection_t *);
    xcb_generic_event_t *(*poll_for_event)(xcb_connection_t *);
    xcb_intern_atom_cookie_t (*intern_atom)(xcb_connection_t *, uint8_t,
                                            uint16_t, const char *);
    xcb_intern_atom_reply_t *(*intern_atom_reply)(
        xcb_connection_t *, xcb_intern_atom_cookie_t, void **);
    xcb_void_cookie_t (*change_property)(
        xcb_connection_t *, uint8_t mode, uint32_t window, uint32_t property,
        uint32_t type, uint8_t format, uint32_t data_len, const void *data);
    xcb_kbmap_cookie_t (*get_keyboard_mapping)(xcb_connection_t *, uint8_t,
                                               uint8_t);
    xcb_get_keyboard_mapping_reply_t *(*get_keyboard_mapping_reply)(
        xcb_connection_t *, xcb_kbmap_cookie_t, void **);
    uint32_t *(*get_keyboard_mapping_keysyms)(
        const xcb_get_keyboard_mapping_reply_t *);
    xcb_void_cookie_t (*warp_pointer)(
        xcb_connection_t *, uint32_t src_window, uint32_t dst_window,
        int16_t src_x, int16_t src_y, uint16_t src_w, uint16_t src_h,
        int16_t dst_x, int16_t dst_y);
    xcb_void_cookie_t (*create_pixmap)(xcb_connection_t *, uint8_t depth,
                                       uint32_t pid, uint32_t drawable,
                                       uint16_t w, uint16_t h);
    xcb_void_cookie_t (*free_pixmap)(xcb_connection_t *, uint32_t);
    xcb_void_cookie_t (*create_cursor)(
        xcb_connection_t *, uint32_t cid, uint32_t source, uint32_t mask,
        uint16_t fore_r, uint16_t fore_g, uint16_t fore_b, uint16_t back_r,
        uint16_t back_g, uint16_t back_b, uint16_t x, uint16_t y);
    xcb_void_cookie_t (*free_cursor)(xcb_connection_t *, uint32_t);
    xcb_void_cookie_t (*change_window_attributes)(
        xcb_connection_t *, uint32_t window, uint32_t value_mask,
        const void *value_list);
};

bool load_api(XcbApi &api) {
    api.lib = dlopen("libxcb.so.1", RTLD_LAZY | RTLD_LOCAL);
    if (!api.lib) return false;
    auto sym = [&](const char *name) { return dlsym(api.lib, name); };
#define LOAD(field, name)                                                  \
    *reinterpret_cast<void **>(&api.field) = sym(name);                    \
    if (!api.field) return false;
    LOAD(connect, "xcb_connect")
    LOAD(connection_has_error, "xcb_connection_has_error")
    LOAD(disconnect, "xcb_disconnect")
    LOAD(get_setup, "xcb_get_setup")
    LOAD(setup_roots_iterator, "xcb_setup_roots_iterator")
    LOAD(generate_id, "xcb_generate_id")
    LOAD(create_window, "xcb_create_window")
    LOAD(map_window, "xcb_map_window")
    LOAD(create_gc, "xcb_create_gc")
    LOAD(put_image, "xcb_put_image")
    LOAD(flush, "xcb_flush")
    LOAD(poll_for_event, "xcb_poll_for_event")
    LOAD(intern_atom, "xcb_intern_atom")
    LOAD(intern_atom_reply, "xcb_intern_atom_reply")
    LOAD(change_property, "xcb_change_property")
    LOAD(get_keyboard_mapping, "xcb_get_keyboard_mapping")
    LOAD(get_keyboard_mapping_reply, "xcb_get_keyboard_mapping_reply")
    LOAD(get_keyboard_mapping_keysyms, "xcb_get_keyboard_mapping_keysyms")
    LOAD(warp_pointer, "xcb_warp_pointer")
    LOAD(create_pixmap, "xcb_create_pixmap")
    LOAD(free_pixmap, "xcb_free_pixmap")
    LOAD(create_cursor, "xcb_create_cursor")
    LOAD(free_cursor, "xcb_free_cursor")
    LOAD(change_window_attributes, "xcb_change_window_attributes")
#undef LOAD
    return true;
}

constexpr uint16_t XCB_WINDOW_CLASS_INPUT_OUTPUT = 1;
constexpr uint32_t XCB_CW_BACK_PIXEL = 2;
constexpr uint32_t XCB_CW_EVENT_MASK = 2048;
constexpr uint32_t XCB_GC_FOREGROUND = 4;
constexpr uint8_t XCB_IMAGE_FORMAT_Z_PIXMAP = 2;
constexpr uint8_t XCB_PROP_MODE_REPLACE = 0;
constexpr uint32_t EVENT_MASK =
    0x00000001    // KeyPress
    | 0x00000002  // KeyRelease
    | 0x00000004  // ButtonPress
    | 0x00000008  // ButtonRelease
    | 0x00000040  // PointerMotion
    | 0x00020000  // StructureNotify
    | 0x00008000; // Exposure

struct BangWindow {
    XcbApi api;
    xcb_connection_t *conn = nullptr;
    uint32_t win = 0, gc = 0;
    int width = 0, height = 0;
    uint32_t wm_delete_atom = 0;
    bool should_close = false;
    uint8_t min_keycode = 8;
    uint8_t depth = 24;           // root depth (PutImage must match)
    int keysyms_per_code = 0;
    uint32_t *keysyms = nullptr;  // owned (reply buffer)
    void *keysyms_reply = nullptr;
    uint8_t *bgra = nullptr;      // conversion scratch
    size_t bgra_cap = 0;
    bool cursor_locked = false;
    uint32_t blank_cursor = 0;    // invisible cursor shown while locked
};

uint32_t intern(BangWindow *w, const char *name, bool only_if_exists) {
    auto ck = w->api.intern_atom(w->conn, only_if_exists ? 1 : 0,
                                 (uint16_t)strlen(name), name);
    xcb_intern_atom_reply_t *r = w->api.intern_atom_reply(w->conn, ck, nullptr);
    uint32_t atom = r ? r->atom : 0;
    free(r);
    return atom;
}

}  // namespace

extern "C" {

// Open a window; returns NULL when no X server / libxcb is available.
void *bang_win_open(int width, int height, const char *title) {
    BangWindow *w = new BangWindow();
    if (!load_api(w->api)) { delete w; return nullptr; }
    int screen_num = 0;
    w->conn = w->api.connect(nullptr, &screen_num);
    if (!w->conn || w->api.connection_has_error(w->conn)) {
        if (w->conn) w->api.disconnect(w->conn);
        delete w;
        return nullptr;
    }
    const xcb_setup_t *setup = w->api.get_setup(w->conn);
    xcb_screen_iterator_t it = w->api.setup_roots_iterator(setup);
    xcb_screen_t *screen = it.data;  // first screen (multi-screen X is rare)
    (void)screen_num;
    // the BGRX ZPixmap upload below is only valid against a 24-bit root;
    // on 16/30-bit displays every PutImage would fail BadMatch with a
    // silently blank window — degrade to headless instead
    if (screen->root_depth != 24) {
        w->api.disconnect(w->conn);
        delete w;
        return nullptr;
    }
    w->depth = screen->root_depth;
    w->width = width;
    w->height = height;
    w->win = w->api.generate_id(w->conn);
    uint32_t values[2] = {screen->black_pixel, EVENT_MASK};
    w->api.create_window(w->conn, /*depth=*/0 /* copy from parent */,
                         w->win, screen->root, 0, 0,
                         (uint16_t)width, (uint16_t)height, 0,
                         XCB_WINDOW_CLASS_INPUT_OUTPUT, screen->root_visual,
                         XCB_CW_BACK_PIXEL | XCB_CW_EVENT_MASK, values);
    w->gc = w->api.generate_id(w->conn);
    uint32_t gcv[1] = {screen->black_pixel};
    w->api.create_gc(w->conn, w->gc, w->win, XCB_GC_FOREGROUND, gcv);

    // WM_DELETE_WINDOW close handshake + title
    uint32_t wm_protocols = intern(w, "WM_PROTOCOLS", true);
    w->wm_delete_atom = intern(w, "WM_DELETE_WINDOW", false);
    if (wm_protocols && w->wm_delete_atom) {
        w->api.change_property(w->conn, XCB_PROP_MODE_REPLACE, w->win,
                               wm_protocols, 4 /*ATOM*/, 32, 1,
                               &w->wm_delete_atom);
    }
    if (title) {
        w->api.change_property(w->conn, XCB_PROP_MODE_REPLACE, w->win,
                               39 /*WM_NAME*/, 31 /*STRING*/, 8,
                               (uint32_t)strlen(title), title);
    }

    // keyboard mapping (keycode -> keysym) for host-side key naming
    w->min_keycode = setup->min_keycode;
    uint8_t count = (uint8_t)(setup->max_keycode - setup->min_keycode + 1);
    auto kck = w->api.get_keyboard_mapping(w->conn, setup->min_keycode, count);
    xcb_get_keyboard_mapping_reply_t *kr =
        w->api.get_keyboard_mapping_reply(w->conn, kck, nullptr);
    if (kr) {
        w->keysyms_per_code = kr->keysyms_per_keycode;
        w->keysyms = w->api.get_keyboard_mapping_keysyms(kr);
        w->keysyms_reply = kr;  // keysyms points into the reply; keep it
    }

    w->api.map_window(w->conn, w->win);
    w->api.flush(w->conn);
    return w;
}

void bang_win_set_title(void *handle, const char *title) {
    auto *w = static_cast<BangWindow *>(handle);
    if (!w || !title) return;
    w->api.change_property(w->conn, XCB_PROP_MODE_REPLACE, w->win,
                           39 /*WM_NAME*/, 31 /*STRING*/, 8,
                           (uint32_t)strlen(title), title);
    w->api.flush(w->conn);
}

// Blit an RGBA8 frame.  Converts to the X ZPixmap BGRX layout and uploads in
// row bands that respect the server's maximum request length.
void bang_win_present(void *handle, const uint8_t *rgba, int width,
                      int height) {
    auto *w = static_cast<BangWindow *>(handle);
    if (!w || !rgba) return;
    size_t need = (size_t)width * height * 4;
    if (w->bgra_cap < need) {
        free(w->bgra);
        w->bgra = (uint8_t *)malloc(need);
        w->bgra_cap = need;
    }
    const uint8_t *src = rgba;
    uint8_t *dst = w->bgra;
    for (size_t i = 0; i < (size_t)width * height; ++i) {
        dst[0] = src[2];  // B
        dst[1] = src[1];  // G
        dst[2] = src[0];  // R
        dst[3] = 0;
        dst += 4;
        src += 4;
    }
    // classic max request length is 2^18 * 4 bytes = 256 KiB; stay under it
    const xcb_setup_t *setup = w->api.get_setup(w->conn);
    size_t max_bytes = ((size_t)setup->maximum_request_length * 4);
    if (max_bytes < 32768) max_bytes = 32768;
    size_t row_bytes = (size_t)width * 4;
    int rows_per_band = (int)((max_bytes - 1024) / row_bytes);
    if (rows_per_band < 1) rows_per_band = 1;
    for (int y = 0; y < height; y += rows_per_band) {
        int band = height - y < rows_per_band ? height - y : rows_per_band;
        w->api.put_image(w->conn, XCB_IMAGE_FORMAT_Z_PIXMAP, w->win, w->gc,
                         (uint16_t)width, (uint16_t)band, 0, (int16_t)y, 0,
                         w->depth, (uint32_t)(row_bytes * band),
                         w->bgra + row_bytes * (size_t)y);
    }
    w->api.flush(w->conn);
}

// Drain pending events.  Each event writes 4 ints: (kind, a, b, c) where
// kind: 1 key-press(keysym), 2 key-release(keysym), 3 button-press(button,
// x, y), 4 button-release, 5 motion(x, y), 6 close-requested, 7 resize(w,h).
// Returns number of events written (at most cap).
int bang_win_poll(void *handle, int32_t *out, int cap) {
    auto *w = static_cast<BangWindow *>(handle);
    if (!w) return 0;
    int n = 0;
    xcb_generic_event_t *ev;
    while ((ev = w->api.poll_for_event(w->conn)) != nullptr) {
        uint8_t type = ev->response_type & 0x7F;
        if (n + 1 <= cap) {
            auto *ie = reinterpret_cast<xcb_input_event_t *>(ev);
            int32_t *slot = out + 4 * n;
            switch (type) {
            case 2:    // KeyPress
            case 3: {  // KeyRelease
                uint32_t sym = 0;
                int idx = (int)ie->detail - (int)w->min_keycode;
                if (w->keysyms && idx >= 0)
                    sym = w->keysyms[idx * w->keysyms_per_code];
                slot[0] = (type == 2) ? 1 : 2;
                slot[1] = (int32_t)sym;
                slot[2] = slot[3] = 0;
                ++n;
                break;
            }
            case 4:    // ButtonPress
            case 5:    // ButtonRelease
                slot[0] = (type == 4) ? 3 : 4;
                slot[1] = ie->detail;
                slot[2] = ie->event_x;
                slot[3] = ie->event_y;
                ++n;
                break;
            case 6:    // MotionNotify
                slot[0] = 5;
                slot[1] = ie->event_x;
                slot[2] = ie->event_y;
                slot[3] = 0;
                ++n;
                break;
            case 33: {  // ClientMessage
                const uint8_t *raw = reinterpret_cast<const uint8_t *>(ev);
                uint32_t data0;
                memcpy(&data0, raw + 12, 4);
                if (data0 == w->wm_delete_atom) {
                    w->should_close = true;
                    slot[0] = 6;
                    slot[1] = slot[2] = slot[3] = 0;
                    ++n;
                }
                break;
            }
            case 22: {  // ConfigureNotify: type,pad,seq(2),event(4),
                        // window(4),above(4),x(2),y(2),width@20,height@22
                const uint8_t *raw = reinterpret_cast<const uint8_t *>(ev);
                int16_t ww, hh;
                memcpy(&ww, raw + 20, 2);
                memcpy(&hh, raw + 22, 2);
                if (ww > 0 && hh > 0) {  // keep warp center current
                    w->width = ww;
                    w->height = hh;
                }
                slot[0] = 7;
                slot[1] = ww;
                slot[2] = hh;
                slot[3] = 0;
                ++n;
                break;
            }
            default:
                break;
            }
        }
        free(ev);
        if (n >= cap) break;
    }
    return n;
}

// Cursor lock for mouse-look: hides the cursor (1x1 invisible cursor) and
// warps the pointer back to the window center after every poll, so look
// deltas never saturate at the screen edge (the GLFW_CURSOR_DISABLED
// behavior the reference relies on, Window.cpp:64-70).  The host side
// measures each motion event against the window center.
void bang_win_set_cursor_locked(void *handle, int locked) {
    auto *w = static_cast<BangWindow *>(handle);
    if (!w) return;
    bool want = locked != 0;
    if (want == w->cursor_locked) return;
    w->cursor_locked = want;
    constexpr uint32_t XCB_CW_CURSOR = 0x4000;
    if (want) {
        if (!w->blank_cursor) {
            uint32_t pix = w->api.generate_id(w->conn);
            w->api.create_pixmap(w->conn, 1, pix, w->win, 1, 1);
            w->blank_cursor = w->api.generate_id(w->conn);
            w->api.create_cursor(w->conn, w->blank_cursor, pix, pix,
                                 0, 0, 0, 0, 0, 0, 0, 0);
            w->api.free_pixmap(w->conn, pix);
        }
        uint32_t v[1] = {w->blank_cursor};
        w->api.change_window_attributes(w->conn, w->win, XCB_CW_CURSOR, v);
        w->api.warp_pointer(w->conn, 0, w->win, 0, 0, 0, 0,
                            (int16_t)(w->width / 2), (int16_t)(w->height / 2));
    } else {
        uint32_t v[1] = {0};  // XCB_CURSOR_NONE -> inherit parent cursor
        w->api.change_window_attributes(w->conn, w->win, XCB_CW_CURSOR, v);
    }
    w->api.flush(w->conn);
}

// Re-center the pointer (called by the host after draining a locked poll).
void bang_win_warp_center(void *handle) {
    auto *w = static_cast<BangWindow *>(handle);
    if (!w || !w->cursor_locked) return;
    w->api.warp_pointer(w->conn, 0, w->win, 0, 0, 0, 0,
                        (int16_t)(w->width / 2), (int16_t)(w->height / 2));
    w->api.flush(w->conn);
}

int bang_win_should_close(void *handle) {
    auto *w = static_cast<BangWindow *>(handle);
    return (w && w->should_close) ? 1 : 0;
}

void bang_win_close(void *handle) {
    auto *w = static_cast<BangWindow *>(handle);
    if (!w) return;
    if (w->conn) w->api.disconnect(w->conn);
    free(w->keysyms_reply);
    free(w->bgra);
    if (w->api.lib) dlclose(w->api.lib);
    delete w;
}

}  // extern "C"
