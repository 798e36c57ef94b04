/* fastio — native host-side parsers for the mad_tpu runtime.
 *
 * The device compute path is JAX/XLA; this extension covers the host I/O
 * that sits in front of it (the reference does this in pure Python:
 * mad/PDB.py:41-69 fixed-column PDB parsing, mad/Dmap.py:13-24 Situs text
 * volumes). Large ensembles re-parse hundreds of PDB frames per run, so the
 * parser matters for end-to-end latency when the host has few cores.
 *
 * Exposed functions:
 *   parse_pdb_bytes(data: bytes) ->
 *       (coords f64[N,3], serial i64[N], res_num i64[N],
 *        names list[str], res_names list[str], chains list[str],
 *        elements list[str], records list[str])
 *   parse_floats(data: bytes) -> f64[M]   (whitespace-separated floats)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdlib.h>
#include <string.h>

/* ---- helpers ---------------------------------------------------------- */

static int parse_int_field(const char *s, int len, long *out) {
    char buf[16];
    if (len >= (int)sizeof(buf)) return -1;
    memcpy(buf, s, len);
    buf[len] = 0;
    char *end;
    long v = strtol(buf, &end, 10);
    if (end == buf) return -1;
    *out = v;
    return 0;
}

static int parse_float_field(const char *s, int len, double *out) {
    char buf[32];
    if (len >= (int)sizeof(buf)) return -1;
    memcpy(buf, s, len);
    buf[len] = 0;
    char *end;
    double v = strtod(buf, &end);
    if (end == buf) return -1;
    *out = v;
    return 0;
}

static PyObject *stripped_str(const char *s, int len) {
    int a = 0, b = len;
    while (a < b && (s[a] == ' ' || s[a] == '\t')) a++;
    while (b > a && (s[b - 1] == ' ' || s[b - 1] == '\t' || s[b - 1] == '\r'))
        b--;
    return PyUnicode_FromStringAndSize(s + a, b - a);
}

/* ---- parse_pdb_bytes --------------------------------------------------- */

static PyObject *parse_pdb_bytes(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    const char *data = (const char *)view.buf;
    Py_ssize_t size = view.len;

    Py_ssize_t cap = 1024, n = 0;
    double *coords = malloc(cap * 3 * sizeof(double));
    long *serials = malloc(cap * sizeof(long));
    long *resnums = malloc(cap * sizeof(long));
    PyObject *names = PyList_New(0);
    PyObject *resnames = PyList_New(0);
    PyObject *chains = PyList_New(0);
    PyObject *elements = PyList_New(0);
    PyObject *records = PyList_New(0);
    if (!coords || !serials || !resnums || !names || !resnames || !chains ||
        !elements || !records)
        goto fail;

    Py_ssize_t pos = 0;
    while (pos < size) {
        Py_ssize_t eol = pos;
        while (eol < size && data[eol] != '\n') eol++;
        int len = (int)(eol - pos);
        const char *line = data + pos;
        pos = eol + 1;

        if (len < 54) continue;
        int is_atom = (strncmp(line, "ATOM", 4) == 0 && (len < 5 ||
                       line[4] == ' ' || line[4] == '\t'));
        int is_het = (strncmp(line, "HETATM", 6) == 0);
        if (!is_atom && !is_het) continue;

        long serial, resnum;
        double x, y, z;
        /* Fixed columns per PDB v3.30 (parity mad/PDB.py:20-54). */
        if (parse_int_field(line + 6, 5, &serial)) continue;
        if (parse_int_field(line + 22, 4, &resnum)) continue;
        if (parse_float_field(line + 30, 8, &x)) continue;
        if (parse_float_field(line + 38, 8, &y)) continue;
        if (parse_float_field(line + 46, 8, &z)) continue;

        if (n == cap) {
            cap *= 2;
            coords = realloc(coords, cap * 3 * sizeof(double));
            serials = realloc(serials, cap * sizeof(long));
            resnums = realloc(resnums, cap * sizeof(long));
            if (!coords || !serials || !resnums) goto fail;
        }
        coords[3 * n] = x;
        coords[3 * n + 1] = y;
        coords[3 * n + 2] = z;
        serials[n] = serial;
        resnums[n] = resnum;
        n++;

        PyObject *o;
        o = stripped_str(line + 12, 4);          /* atom name  */
        PyList_Append(names, o); Py_DECREF(o);
        o = PyUnicode_FromStringAndSize(line + 17, 3);   /* res name */
        PyList_Append(resnames, o); Py_DECREF(o);
        o = PyUnicode_FromStringAndSize(line + 21, 1);   /* chain    */
        PyList_Append(chains, o); Py_DECREF(o);
        o = (len >= 78) ? stripped_str(line + 76, 2)     /* element  */
                        : PyUnicode_FromString("");
        PyList_Append(elements, o); Py_DECREF(o);
        o = PyUnicode_FromString(is_het ? "HETATM" : "ATOM");
        PyList_Append(records, o); Py_DECREF(o);
    }
    PyBuffer_Release(&view);

    /* Hand arrays to Python as bytes; numpy wraps them zero-copy upstream */
    {
        PyObject *c = PyBytes_FromStringAndSize((char *)coords,
                                                n * 3 * sizeof(double));
        PyObject *s = PyBytes_FromStringAndSize((char *)serials,
                                                n * sizeof(long));
        PyObject *r = PyBytes_FromStringAndSize((char *)resnums,
                                                n * sizeof(long));
        free(coords); free(serials); free(resnums);
        PyObject *out = Py_BuildValue("(NNNOOOOO)", c, s, r, names, resnames,
                                      chains, elements, records);
        Py_DECREF(names); Py_DECREF(resnames); Py_DECREF(chains);
        Py_DECREF(elements); Py_DECREF(records);
        return out;
    }

fail:
    PyBuffer_Release(&view);
    free(coords); free(serials); free(resnums);
    Py_XDECREF(names); Py_XDECREF(resnames); Py_XDECREF(chains);
    Py_XDECREF(elements); Py_XDECREF(records);
    return PyErr_NoMemory();
}

/* ---- parse_floats ------------------------------------------------------ */

static PyObject *parse_floats(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    const char *p = (const char *)view.buf;
    const char *end = p + view.len;

    Py_ssize_t cap = 4096, n = 0;
    double *vals = malloc(cap * sizeof(double));
    if (!vals) {
        PyBuffer_Release(&view);
        return PyErr_NoMemory();
    }
    while (p < end) {
        char *next;
        double v = strtod(p, &next);
        if (next == p) {
            p++;
            continue;
        }
        if (n == cap) {
            cap *= 2;
            vals = realloc(vals, cap * sizeof(double));
            if (!vals) {
                PyBuffer_Release(&view);
                return PyErr_NoMemory();
            }
        }
        vals[n++] = v;
        p = next;
    }
    PyBuffer_Release(&view);
    PyObject *b = PyBytes_FromStringAndSize((char *)vals,
                                            n * sizeof(double));
    free(vals);
    return b;
}

/* ---- module ------------------------------------------------------------ */

static PyMethodDef Methods[] = {
    {"parse_pdb_bytes", parse_pdb_bytes, METH_VARARGS,
     "Parse fixed-column PDB ATOM/HETATM records."},
    {"parse_floats", parse_floats, METH_VARARGS,
     "Parse whitespace-separated floats (Situs voxel data)."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "fastio", NULL,
                                       -1, Methods};

PyMODINIT_FUNC PyInit_fastio(void) { return PyModule_Create(&moduledef); }
